"""The port's RG-LRU recurrence, conv, FFN and serving block against the
reference.

Tolerances, each with its reason:

* The plain ``rglru_scan`` (the kernel's CPU version) rounds each product
  and each sum once, in time order.  It is held to ``rglru_tolerance``,
  the f32 rounding bound around the float64 recurrence (worst case per
  step), which a dropped ``h0``, a dropped step or a reversed time order
  exceeds by orders of magnitude (shown below).  The reference's jitted
  ``lax.scan`` (XLA contracts ``a*h + b``) meets the same bound.  Its
  Pallas kernel scans 256-row chunks in log steps, another order with
  more roundings: it is held to its own test's bound
  (``tests/test_kernels.py``: 1e-4 absolute and relative).
* The conv (``conv1d_prefill``/``conv1d_decode``): the reference's einsum
  sums four f32 products and rounds once to the activation dtype, as the
  port does: equal to one rounding of that dtype (2^-8 relative in bf16,
  1e-6 in f32), the f32 sum order aside.
* The block (``rglru_decode``/``rglru_prefill``) with f32 params: within
  1e-5 of each leaf's largest magnitude.  With bf16 params the port
  rounds every op to bf16 where XLA's fusions keep f32 inside: within
  2^-6 of the scale for the output stream and the conv window, 2^-7 for
  the f32 state.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import rglru as JG
from repro.models.config import HybridConfig
from repro_torch import interop
from repro_torch.kernels import chunk_scan as tcs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.models import rglru as TG


def _ab(rng, lead, t, d, *, lo=0.0, hi=0.98):
    a = (lo + (hi - lo) * rng.random(lead + (t, d))).astype(np.float32)
    b = rng.standard_normal(lead + (t, d)).astype(np.float32)
    return a, b


def _within(got, exact, tol, what):
    err = (torch.as_tensor(np.asarray(got, np.float64)).double()
           - exact).abs()
    ratio = (err / tol.clamp_min(1e-300)).max().item()
    assert bool((err <= tol).all()), f"{what}: {ratio:.3g} x the bound"
    return ratio


# ---------------------------------------------------------------------------
# the recurrence: plain version vs the reference kernel and scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,d", [(8, 4), (64, 16), (300, 8), (1024, 4)])
def test_plain_matches_the_pallas_kernel(rng, t, d):
    """The sweep of test_kernels.py (``a`` in (0, 0.98)), T across the
    Pallas kernel's 256-row chunks."""
    a, b = _ab(rng, (), t, d)
    want = np.asarray(jops.rglru_scan(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = tcs.rglru_scan(ta, tb)
    assert got.dtype == torch.float32 and tuple(got.shape) == (t, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    exact, tol = tcs.rglru_tolerance(ta, tb)
    _within(got, exact, tol, "port")
    _within(np.asarray(jref.rglru_scan(jnp.asarray(a), jnp.asarray(b))),
            exact, tol, "reference lax.scan")
    assert torch.equal(tops.rglru_scan(ta, tb), got)


@pytest.mark.parametrize("lead", [(3,), (2, 3)])
def test_batched_with_state_matches_the_reference_scan(rng, lead):
    """``[..., T, D]`` with batch dims and h0, each row against the
    reference's ``kernels.ref.rglru_scan`` from that row's h0 (a in the
    model's range near init, (0.9, 1))."""
    t, d = 40, 24
    a, b = _ab(rng, lead, t, d, lo=0.9, hi=1.0)
    h0 = rng.standard_normal(lead + (d,)).astype(np.float32)
    ta, tb, th0 = map(torch.from_numpy, (a, b, h0))
    got = tcs.rglru_scan(ta, tb, th0)
    exact, tol = tcs.rglru_tolerance(ta, tb, th0)
    _within(got, exact, tol, "port")
    rows = [np.asarray(jref.rglru_scan(jnp.asarray(ai), jnp.asarray(bi),
                                       jnp.asarray(hi)))
            for ai, bi, hi in zip(a.reshape(-1, t, d), b.reshape(-1, t, d),
                                  h0.reshape(-1, d))]
    _within(np.stack(rows).reshape(lead + (t, d)), exact, tol,
            "reference")
    # each row alone equals its slice of the batched call
    flat = got.reshape(-1, t, d)
    for i, (ai, bi, hi) in enumerate(zip(ta.reshape(-1, t, d),
                                         tb.reshape(-1, t, d),
                                         th0.reshape(-1, d))):
        assert torch.equal(tref.rglru_scan(ai, bi, hi), flat[i])


def test_bf16_inputs_compute_in_f32(rng):
    a, b = _ab(rng, (2,), 30, 8, lo=0.9, hi=1.0)
    bf = ml_dtypes.bfloat16
    ta, tb = (interop._to_torch(x.astype(bf)) for x in (a, b))
    got = tcs.rglru_scan(ta, tb)
    assert got.dtype == torch.float32
    assert torch.equal(got, tcs.rglru_scan(ta.float(), tb.float()))
    exact, tol = tcs.rglru_tolerance(ta, tb)
    _within(got, exact, tol, "bf16 inputs")


def test_tolerance_catches_a_dropped_h0_step_or_reversed_time(rng):
    t, d = 64, 16
    a, b = _ab(rng, (2,), t, d, lo=0.9, hi=1.0)
    h0 = rng.standard_normal((2, d)).astype(np.float32)
    ta, tb, th0 = map(torch.from_numpy, (a, b, h0))
    exact, tol = tcs.rglru_tolerance(ta, tb, th0)
    assert _within(tcs.rglru_scan(ta, tb, th0), exact, tol, "port") <= 1
    b_drop = tb.clone()
    b_drop[:, 40] = 0                         # step 40's input never enters
    a_drop = ta.clone()
    a_drop[:, 40] = 1
    bad = [tref.rglru_scan(ta, tb),           # h0 dropped
           tref.rglru_scan(a_drop, b_drop, th0),
           tref.rglru_scan(ta.flip(1), tb.flip(1), th0).flip(1)]
    for h in bad:
        err = (h.double() - exact).abs()
        assert (err / tol).max().item() > 100


def test_wrapper_writes_the_final_state_and_checks_shapes(rng):
    a, b = _ab(rng, (3,), 7, 5)
    ta, tb = map(torch.from_numpy, (a, b))
    h0 = torch.randn(3, 5)
    keep = h0.clone()
    ptr = h0.data_ptr()
    got = tcs.rglru_scan(ta, tb, h0, h_out=h0)
    assert h0.data_ptr() == ptr and torch.equal(h0, got[:, -1])
    assert torch.equal(got, tref.rglru_scan(ta, tb, keep))
    # T = 0: h is empty and the state passes through (zeros without h0)
    out = torch.full((3, 5), 7.0)
    empty = tcs.rglru_scan(ta[:, :0], tb[:, :0], keep, h_out=out)
    assert empty.shape == (3, 0, 5) and torch.equal(out, keep)
    tcs.rglru_scan(ta[:, :0], tb[:, :0], h_out=out)
    assert not out.any()
    with pytest.raises(ValueError, match="share"):
        tcs.rglru_scan(ta, tb[:, :3])
    with pytest.raises(ValueError, match="h0"):
        tcs.rglru_scan(ta, tb, torch.zeros(3, 4))
    before = tcs.rglru_launches
    tcs.rglru_scan(ta, tb)
    assert tcs.rglru_launches == before          # a CPU tensor: plain


def test_kernel_reads_strided_views_or_raises():
    """(folded batch, time) element strides of ``[*batch, T, D]`` views;
    a lane dim that is not unit-stride, or batch dims that do not fold,
    raise rather than copy."""
    x = torch.empty(8, 512, 4096)
    assert tcs._bt_strides(x, "a") == (512 * 4096, 4096)
    assert tcs._bt_strides(x[:, ::2], "a") == (512 * 4096, 2 * 4096)
    assert tcs._bt_strides(torch.empty(2, 3, 7, 5), "a") == (35, 5)
    assert tcs._bt_strides(torch.empty(7, 5), "a") == (0, 5)
    with pytest.raises(ValueError, match="fold"):
        tcs._bt_strides(torch.empty(2, 3, 7, 5).transpose(0, 1), "a")
    with pytest.raises(ValueError, match="unit-stride"):
        tcs._bt_strides(x.transpose(1, 2), "a")


# ---------------------------------------------------------------------------
# layers: the conv, GeGLU and RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 2, 9])
def test_conv_prefill_is_the_reference_decode_conv_stepped(rng, dtype, t):
    jdt = getattr(jnp, dtype)
    p = JL.init_conv1d(jax.random.key(1), 4, 32, jdt)
    p["bias"] = jnp.asarray(rng.standard_normal(32), jdt)
    win = jnp.asarray(rng.standard_normal((2, 3, 32)), jdt)
    x = jnp.asarray(rng.standard_normal((2, t, 32)), jdt)
    ys, w = [], win
    for i in range(t):
        y, w = JL.conv1d_decode(p, w, x[:, i])
        ys.append(np.asarray(y, np.float32))
    tp = interop.params_from_reference(p)
    got, got_w = TL.conv1d_prefill(tp, interop._to_torch(np.asarray(win)),
                                   interop._to_torch(np.asarray(x)))
    tol = 2.0 ** -8 if dtype == "bfloat16" else 1e-6
    want = np.stack(ys, 1)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())
    assert torch.equal(got_w.float(), interop._to_torch(np.asarray(
        w, np.float32)))
    # the one-step form is the prefill's T = 1 case
    y1, w1 = TL.conv1d_decode(tp, interop._to_torch(np.asarray(win)),
                              interop._to_torch(np.asarray(x[:, 0])))
    assert torch.equal(y1, got[:, 0]) and w1.shape == (2, 3, 32)


def test_causal_conv_matches_the_reference(rng):
    p = JL.init_conv1d(jax.random.key(2), 4, 16, jnp.float32)
    x = rng.standard_normal((2, 11, 16)).astype(np.float32)
    want = np.asarray(JL.causal_conv1d(p, jnp.asarray(x)))
    got = TL.causal_conv1d(interop.params_from_reference(p),
                           torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("activation", ["geglu", "swiglu", "relu2", "gelu"])
def test_ffn_matches_the_reference(rng, activation):
    """f32: within 1e-5 (matmul sums in another order; gelu is the tanh
    approximation on both sides)."""
    p = JL.init_ffn(jax.random.key(3), 32, 64, activation, jnp.float32)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    want = np.asarray(JL.ffn(p, jnp.asarray(x), activation))
    tp = interop.params_from_reference(p)
    assert TL.init_ffn(None, 32, 64, activation, device="meta").keys() \
        == tp.keys()
    got = TL.ffn(tp, torch.from_numpy(x), activation)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_the_reference(rng, per_row):
    """Positions up to 3,000 (past the hybrid window): within 2e-6 of the
    largest magnitude (cos and sin of large f32 angles differ in the last
    bits between libraries)."""
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, (3, 5)) if per_row else \
        np.arange(5)[None] + 2990
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-6 * np.abs(want).max())
    np.testing.assert_allclose(
        TL.rope_frequencies(16).numpy(),
        np.asarray(JL.rope_frequencies(16)), rtol=1e-7)


# ---------------------------------------------------------------------------
# the serving block: rglru_decode / rglru_prefill vs the reference's decode
# ---------------------------------------------------------------------------

D, W = 64, 96
HCFG = HybridConfig(pattern=("lru", "lru", "attn"), window=16, lru_width=W,
                    conv_width=4)


def _block(rng, dtype):
    """The reference's seeded init, with the gates' zero vectors and the
    conv bias drawn so that every term of the block is exercised."""
    jp = JG.init_rglru(jax.random.key(4), D, HCFG, dtype)
    for k in ("w_r", "b_r", "w_i", "b_i"):
        jp[k] = jnp.asarray(rng.standard_normal(W).astype(np.float32) * 0.5)
    jp["conv"]["bias"] = jnp.asarray(rng.standard_normal(W) * 0.1, dtype)
    return jp, interop.params_from_reference(jp)


def _cache(rng, b, dtype, zero: bool):
    c = {"h": np.zeros((b, W), np.float32),
         "conv": np.zeros((b, 3, W), np.float32)}
    if not zero:
        c = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in c.items()}
    if dtype == jnp.bfloat16:
        c["conv"] = c["conv"].astype(ml_dtypes.bfloat16)
    return c


def _reference_steps(jp, x, cache):
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    step = jax.jit(lambda xx, cc: JG.rglru_decode(jp, xx, cc, cfg=HCFG))
    outs = []
    for t in range(x.shape[1]):
        y, jc = step(jnp.asarray(x[:, t:t + 1]), jc)
        outs.append(np.asarray(y, np.float32))
    return np.concatenate(outs, 1), {k: np.asarray(v, np.float32)
                                     for k, v in jc.items()}


def _port(tp, x, cache, *, decode: bool):
    tc = interop.cache_from_reference(cache)
    tx = interop._to_torch(x)
    if decode:
        ys = []
        for t in range(tx.shape[1]):
            y, tc = TG.rglru_decode(tp, tx[:, t:t + 1], tc)
            ys.append(y)
        y = torch.cat(ys, 1)
    else:
        y, tc = TG.rglru_prefill(tp, tx, tc)
    return y.float().numpy(), {k: v.float().numpy() for k, v in tc.items()}


def _close(got, want, dtype, what):
    scale = np.abs(want).max()
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=what)
    else:
        tol = 2.0 ** -7 if what == "h" else 2.0 ** -6
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                                   err_msg=what)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["decode", "prefill"])
@pytest.mark.parametrize("zero", [True, False], ids=["zero", "carried"])
def test_block_matches_reference_decode_steps(rng, dtype, mode, zero):
    """``rglru_decode`` stepped, and ``rglru_prefill`` in one call, against
    T jitted calls of the reference's ``rglru_decode``, from a zero and a
    carried (random) cache: outputs and both cache leaves."""
    jp, tp = _block(rng, dtype)
    b, t = 2, 9
    x = rng.standard_normal((b, t, D)).astype(np.float32)
    if dtype == jnp.bfloat16:
        x = x.astype(ml_dtypes.bfloat16)
    cache = _cache(rng, b, dtype, zero)
    want_y, want_c = _reference_steps(jp, x, cache)
    got_y, got_c = _port(tp, x, cache, decode=mode == "decode")
    _close(got_y, want_y, dtype, "y")
    for k in want_c:
        _close(got_c[k], want_c[k], dtype, k)


def test_prefill_equals_its_decode_steps_and_updates_in_place(rng):
    """In the port the prefill and T decode steps do the same arithmetic
    (the conv's decode form, the scan in time order): equal bit for bit,
    and the cache tensors are written in place."""
    _, tp = _block(rng, jnp.bfloat16)
    x = interop._to_torch(rng.standard_normal((2, 6, D)).astype(
        ml_dtypes.bfloat16))
    c_pre = interop.cache_from_reference(_cache(rng, 2, jnp.bfloat16, False))
    c_dec = {k: v.clone() for k, v in c_pre.items()}
    ptrs = {k: v.data_ptr() for k, v in c_pre.items()}
    y_pre, out = TG.rglru_prefill(tp, x, c_pre)
    assert out is c_pre
    assert all(v.data_ptr() == ptrs[k] for k, v in c_pre.items())
    ys = [TG.rglru_decode(tp, x[:, t:t + 1], c_dec)[0] for t in range(6)]
    assert torch.equal(torch.cat(ys, 1), y_pre)
    for k in c_pre:
        assert torch.equal(c_pre[k], c_dec[k]), k
    plain = interop.cache_from_reference(_cache(rng, 2, jnp.bfloat16, True))
    kern = {k: v.clone() for k, v in plain.items()}
    y_k, _ = TG.rglru_prefill(tp, x, kern)
    y_p, _ = TG.rglru_prefill(tp, x, plain, use_kernels=False)
    assert torch.equal(y_k, y_p) and torch.equal(kern["h"], plain["h"])
    with pytest.raises(ValueError, match="one token"):
        TG.rglru_decode(tp, x, c_dec)


def test_init_follows_the_reference_tree_and_lambda_range():
    jp = JG.init_rglru(jax.random.key(0), D, HCFG, jnp.bfloat16)
    tp = TG.init_rglru(torch.Generator().manual_seed(0), D, HCFG,
                       lead=(3,))
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat_j:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == (3,) + tuple(leaf.shape), path
        assert str(node.dtype).split(".")[1] == str(np.dtype(leaf.dtype))
    # a = exp(-8 softplus(lam) r) in (0.9, 0.999) at r = 1/2, as drawn
    a = torch.exp(-8 * torch.nn.functional.softplus(tp["lam"]) * 0.5)
    assert bool(((a > 0.9 - 1e-6) & (a < 0.999 + 1e-6)).all())
