"""The port's attention (flash attention, the GQA layer, sliding-window
serving with a ring buffer) against the reference.

Tolerances, each with its reason:

* ``flash_attention`` and ``gqa_attention`` in f32: within 2e-6 of the
  output's largest magnitude (the same online-softmax algorithm over the
  same chunks; exp and the einsum sums round differently between XLA and
  PyTorch).
* ``window_decode`` / ``window_prefill`` against T jitted calls of the
  reference's ``window_decode``, f32 params: within 1e-5 of each leaf's
  largest magnitude (prefill takes the online softmax over the prompt,
  decode a plain softmax over the ring: another summation order).  bf16
  params: within 2^-6 for the output and the cached k and v (one bf16
  rounding of the projections and of the attention output, two ulps at
  the largest value); ``pos`` equal.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch import interop
from repro_torch.models import attention as TA

H, KV, DH, DM = 4, 1, 16, 32


def _qkv(rng, b, tq, tk, hq=H, hkv=KV, d=DH):
    q = rng.standard_normal((b, tq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, hkv, d)).astype(np.float32)
    return q, k, v


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * np.abs(want).max())


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,chunk", [
    (True, None, 8), (True, 5, 8), (True, 5, 7), (False, None, 6),
    (True, 40, 1024), (False, 3, 8)])
@pytest.mark.parametrize("hq,hkv", [(4, 1), (4, 2), (2, 2)])
def test_flash_attention_matches_the_reference(rng, causal, window, chunk,
                                               hq, hkv):
    """MQA (1 KV head), GQA and MHA; causal, window and full masks; KV
    chunks that divide the sequence and a ragged last chunk."""
    q, k, v = _qkv(rng, 2, 19, 19, hq, hkv)
    want = JA.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                              window=window, chunk=chunk)
    got = TA.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal, window=window, chunk=chunk)
    assert got.shape == (2, 19, hq, DH) and got.dtype == torch.float32
    _close(got, want, 2e-6)


@pytest.mark.parametrize("per_row", [False, True])
def test_flash_attention_offsets_and_kv_len(rng, per_row):
    """A query block at ``q_offset`` (scalar, or one position per row as
    continuous batching gives it) over a KV prefix of ``kv_len``."""
    q, k, v = _qkv(rng, 3, 2, 24)
    off = np.array([3, 10, 21]) if per_row else 9
    kv_len = off + 2
    args = dict(causal=True, window=6, chunk=8)
    want = JA.flash_attention(*map(jnp.asarray, (q, k, v)),
                              q_offset=jnp.asarray(off),
                              kv_len=jnp.asarray(kv_len), **args)
    got = TA.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             q_offset=torch.as_tensor(off),
                             kv_len=torch.as_tensor(kv_len), **args)
    _close(got, want, 2e-6)


def test_gqa_attention_with_a_window_matches_the_reference(rng):
    p = JA.init_gqa(jax.random.key(0), DM, H, KV, DH, dtype=jnp.float32)
    x = rng.standard_normal((2, 21, DM)).astype(np.float32)
    kw = dict(n_heads=H, n_kv=KV, d_head=DH, window=6, chunk=8,
              q_offset=4)
    want = JA.gqa_attention(p, jnp.asarray(x), **kw)
    tp = interop.params_from_reference(p)
    got = TA.gqa_attention(tp, torch.from_numpy(x), **kw)
    _close(got, want, 2e-6)
    assert TA.init_gqa(None, DM, H, KV, DH, device="meta").keys() \
        == tp.keys()


# ---------------------------------------------------------------------------
# sliding-window serving: the ring buffer
# ---------------------------------------------------------------------------

WINDOW = 8


def _layer(dtype):
    return JA.init_gqa(jax.random.key(5), DM, H, KV, DH, dtype=dtype)


def _empty(b, slots, dtype):
    c = JA.init_window_cache(b, slots, KV, DH, dtype)
    return jax.tree.map(np.asarray, c)


def _reference_steps(jp, x, cache, positions, window=WINDOW):
    """One jitted reference ``window_decode`` per token; ``positions`` is
    [T] (lockstep) or [T, B] (per row)."""
    step = jax.jit(lambda xx, cc, i: JA.window_decode(
        jp, xx, cc, i, n_heads=H, n_kv=KV, d_head=DH, window=window))
    jc = jax.tree.map(jnp.asarray, cache)
    ys = []
    for t in range(x.shape[1]):
        y, jc = step(jnp.asarray(x[:, t:t + 1]), jc,
                     jnp.asarray(positions[t]))
        ys.append(np.asarray(y, np.float32))
    return np.concatenate(ys, 1), jax.tree.map(np.asarray, jc)


def _port_steps(tp, x, cache, positions, window=WINDOW):
    tc = interop.cache_from_reference(cache)
    ptrs = {k: v.data_ptr() for k, v in tc.items()}
    tx = interop._to_torch(x)
    ys = []
    for t in range(tx.shape[1]):
        pos = positions[t]
        pos = torch.as_tensor(pos) if np.ndim(pos) else int(pos)
        y, out = TA.window_decode(tp, tx[:, t:t + 1], tc, pos, n_heads=H,
                                  n_kv=KV, d_head=DH, window=window)
        assert out is tc
        ys.append(y)
    assert {k: v.data_ptr() for k, v in tc.items()} == ptrs
    return torch.cat(ys, 1), tc


def _hold(got_y, got_c, want_y, want_c, dtype):
    rel = 1e-5 if dtype == jnp.float32 else 2.0 ** -6
    _close(got_y.float(), want_y, rel)
    for k in ("k", "v"):
        _close(got_c[k].float(), want_c[k], rel)
    assert np.array_equal(got_c["pos"].numpy(), want_c["pos"])


def _x(rng, b, t, dtype):
    x = rng.standard_normal((b, t, DM)).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == jnp.bfloat16 else x


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [5, 8, 19])
def test_window_decode_steps_match_the_reference(rng, dtype, t):
    """Decode from an empty ring; 19 steps wrap it twice past the window
    of 8."""
    jp = _layer(dtype)
    x = _x(rng, 2, t, dtype)
    cache = _empty(2, WINDOW, dtype)
    want = _reference_steps(jp, x, cache, np.arange(t))
    got = _port_steps(interop.params_from_reference(jp), x, cache,
                      np.arange(t))
    _hold(*got, *want, dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_window_decode_per_row_positions_match_the_reference(rng, dtype):
    """Continuous batching: each row at its own position (one past the
    window, one wrapping mid-way, one just admitted with a reset ring),
    so RoPE, the ring slot and the mask differ per row."""
    jp = _layer(dtype)
    b, t = 3, 12
    x = _x(rng, b, t, dtype)
    cache = _empty(b, WINDOW, dtype)
    start = np.array([0, 5, 14])
    positions = start[None, :] + np.arange(t)[:, None]       # [T, B]
    want = _reference_steps(jp, x, cache, positions)
    got = _port_steps(interop.params_from_reference(jp), x, cache,
                      positions)
    _hold(*got, *want, dtype)


def test_window_decode_drops_a_slot_past_a_short_ring(rng):
    """A ring of 6 slots (``min(window, seq)`` with seq 6) asked for
    positions 6 and 7: the reference's scatter drops those writes, and so
    does the port's (``index_put_`` alone would raise)."""
    jp = _layer(jnp.float32)
    x = _x(rng, 2, 8, jnp.float32)
    cache = _empty(2, 6, jnp.float32)
    want = _reference_steps(jp, x, cache, np.arange(8))
    got = _port_steps(interop.params_from_reference(jp), x, cache,
                      np.arange(8))
    _hold(*got, *want, jnp.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t,slots", [(5, WINDOW), (8, WINDOW),
                                     (19, WINDOW), (5, 6)])
def test_window_prefill_matches_the_reference_decode_steps(rng, dtype, t,
                                                           slots):
    """``window_prefill`` of a whole prompt against T reference decode
    steps from an empty ring: prompts shorter than, equal to and past the
    window (the ring holds the last 8 keys at slots ``pos % 8``), and a
    ring sized below the window; then decode steps after the prefill
    continue the ring as the reference's do."""
    jp = _layer(dtype)
    tp = interop.params_from_reference(jp)
    x = _x(rng, 2, t + 3, dtype)
    cache = _empty(2, slots, dtype)
    want_y, want_c = _reference_steps(jp, x[:, :t], cache, np.arange(t))
    tc = interop.cache_from_reference(cache)
    got_y, out = TA.window_prefill(tp, interop._to_torch(x[:, :t]), tc,
                                   n_heads=H, n_kv=KV, d_head=DH,
                                   window=WINDOW, chunk=4)
    assert out is tc
    _hold(got_y, tc, want_y, want_c, dtype)
    if slots == WINDOW:                       # the ring has room to go on
        more_want = _reference_steps(jp, x[:, t:], want_c,
                                     np.arange(t, t + 3))
        more_got = _port_steps(tp, x[:, t:], interop.params_to_reference(tc),
                               np.arange(t, t + 3))
        _hold(*more_got, *more_want, dtype)


def test_window_prefill_longer_than_a_short_ring_raises(rng):
    tp = interop.params_from_reference(_layer(jnp.float32))
    tc = interop.cache_from_reference(_empty(2, 6, jnp.float32))
    with pytest.raises(ValueError, match="does not fit"):
        TA.window_prefill(tp, torch.randn(2, 7, DM), tc, n_heads=H, n_kv=KV,
                          d_head=DH, window=WINDOW)


def test_window_prefill_empties_a_used_ring(rng):
    """Prefill starts a sequence at position 0: what an earlier sequence
    left in the ring is not attended to, and its positions are cleared."""
    jp = _layer(jnp.float32)
    tp = interop.params_from_reference(jp)
    x = _x(rng, 2, 4, jnp.float32)
    used = interop.cache_from_reference(_empty(2, WINDOW, jnp.float32))
    TA.window_prefill(tp, torch.randn(2, 7, DM), used, n_heads=H, n_kv=KV,
                      d_head=DH, window=WINDOW)
    fresh = interop.cache_from_reference(_empty(2, WINDOW, jnp.float32))
    kw = dict(n_heads=H, n_kv=KV, d_head=DH, window=WINDOW)
    y_used, _ = TA.window_prefill(tp, torch.from_numpy(x), used, **kw)
    y_fresh, _ = TA.window_prefill(tp, torch.from_numpy(x), fresh, **kw)
    assert torch.equal(y_used, y_fresh)
    assert torch.equal(used["pos"], fresh["pos"])
    assert (used["pos"][:, 4:] == -1).all()
