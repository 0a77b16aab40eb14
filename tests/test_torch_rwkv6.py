"""The port's RWKV-6 WKV recurrence and serving block against the reference.

Tolerances, each with its reason:

* The plain ``rwkv6_recurrence`` (the kernel's CPU version) and the
  reference's Pallas kernel (interpret mode) and ``wkv`` scan sum over k
  in different orders, and XLA contracts multiply-adds: both are held to
  ``wkv_tolerance``, the f32 rounding bound around the float64
  recurrence (worst case, linear in T), which a dropped token or a
  dropped ``u`` term exceeds by orders of magnitude (shown below).
* ``kv_bf16=True`` is held to the reference's ``rwkv6_decode`` arithmetic
  (kv formed from bf16 k and v) within the same bound, computed with the
  rounded kv.
* The block (``rwkv6_decode``/``rwkv6_prefill``) with f32 params: within
  1e-5 of each leaf's largest magnitude, and 1e-5 relative (f32 matmul
  sums in another order; 2.8e-7 measured).  With bf16 params the port
  rounds every op to bf16 where XLA's fusions keep f32 inside: within
  2^-6 of the scale for the hidden streams (8.1e-3 measured, two bf16
  ulps at the largest value) and 2^-7 for the f32 state (1.4e-3
  measured).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import rwkv6_recurrence as jrk
from repro.models import layers as JL
from repro.models import rwkv6 as JR
from repro_torch import interop
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_recurrence as trk
from repro_torch.models import layers as TL
from repro_torch.models import rwkv6 as TR

SWEEP = [(1, 16, 8, 8), (2, 64, 16, 16), (4, 100, 32, 32), (2, 130, 64, 64)]


def _inputs(rng, lead, t, k, v, *, w_lo=0.5):
    r = (rng.standard_normal(lead + (t, k)) * 0.5).astype(np.float32)
    kk = (rng.standard_normal(lead + (t, k)) * 0.5).astype(np.float32)
    vv = (rng.standard_normal(lead + (t, v)) * 0.5).astype(np.float32)
    w = (w_lo + (1 - w_lo) * rng.random(lead + (t, k))).astype(np.float32)
    return r, kk, vv, w


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _within(got, exact, tol, what):
    err = (torch.as_tensor(np.asarray(got, np.float64)).double()
           - exact).abs()
    ratio = (err / tol.clamp_min(1e-300)).max().item()
    assert bool((err <= tol).all()), f"{what}: {ratio:.3g} x the bound"
    return ratio


# ---------------------------------------------------------------------------
# the recurrence: plain version vs the reference kernel and scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,t,k,v", SWEEP + [(1, 200, 8, 8)])
def test_plain_matches_pallas_kernel(rng, h, t, k, v):
    """The sweep of test_kernels.py, plus its chunk-carry case (T = 200 >
    the Pallas kernel's 64-token chunk, w = 0.9)."""
    r, kk, vv, w = _inputs(rng, (h,), t, k, v)
    if t == 200:
        w = np.full_like(w, 0.9)
    u = (rng.standard_normal((h, k)) * 0.1).astype(np.float32)
    jo, js = jrk.rwkv6_recurrence(*map(jnp.asarray, (r, kk, vv, w, u)),
                                  interpret=True)
    args = _t(r, kk, vv, w, u)
    o, s = trk.rwkv6_recurrence(*args)
    eo, es, otol, stol = trk.wkv_tolerance(*args)
    for got, ex, tol, what in ((o, eo, otol, "o"), (s, es, stol, "S"),
                               (jo, eo, otol, "pallas o"),
                               (js, es, stol, "pallas S")):
        _within(got, ex, tol, what)
    assert o.dtype == torch.float32 and tuple(o.shape) == (h, t, v)


def test_tolerance_catches_a_dropped_token_or_u_term(rng):
    r, kk, vv, w = _inputs(rng, (2,), 64, 16, 16)
    u = (rng.standard_normal((2, 16)) * 0.1).astype(np.float32)
    args = _t(r, kk, vv, w, u)
    eo, _, otol, _ = trk.wkv_tolerance(*args)
    no_u, _ = tref.rwkv6_recurrence(*args[:4], torch.zeros_like(args[4]))
    k_drop = args[1].clone()
    k_drop[:, 40] = 0                         # token 40 never enters S
    dropped, _ = tref.rwkv6_recurrence(args[0], k_drop, *args[2:])
    for bad in (no_u, dropped):
        err = (bad.double() - eo).abs()
        assert (err / otol).max().item() > 100


def test_batched_with_state_matches_reference_wkv(rng):
    """[B, H, T, K] with batch dims and s0 against the reference's
    ``models.rwkv6.wkv`` ([B, T, H, K], its scan oracle)."""
    b, h, t, k = 3, 2, 20, 64
    r, kk, vv, w = _inputs(rng, (b, h), t, k, k, w_lo=0.9)
    u = (rng.standard_normal((h, k)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((b, h, k, k)).astype(np.float32)
    bthk = [np.ascontiguousarray(a.transpose(0, 2, 1, 3))
            for a in (r, kk, vv, w)]
    jo, js = JR.wkv(*map(jnp.asarray, bthk), jnp.asarray(u),
                    s0=jnp.asarray(s0))
    args = _t(r, kk, vv, w, u, s0)
    o, s = trk.rwkv6_recurrence(*args[:5], args[5])
    eo, es, otol, stol = trk.wkv_tolerance(*args[:5], args[5])
    _within(o, eo, otol, "port o")
    _within(s, es, stol, "port S")
    _within(np.asarray(jo).transpose(0, 2, 1, 3), eo, otol, "reference o")
    _within(js, es, stol, "reference S")
    # the model's own entry point takes the [B, T, H, K] layout
    mo, ms = TR.wkv(*_t(*bthk), args[4], args[5].clone())
    assert torch.equal(mo, o.transpose(1, 2)) and torch.equal(ms, s)


def _decode_wkv_reference(r, k, v, w, u, s):
    """The WKV lines of the reference's ``rwkv6_decode`` (rwkv6.py:
    229-234), stepped over T: kv formed from bf16 k and v, in bf16."""
    os = []
    for t in range(r.shape[1]):
        kt, vt = k[:, t], v[:, t]
        kv = kt[..., :, None] * vt[..., None, :]
        os.append(jnp.einsum("bhkv,bhk->bhv", s + u[:, :, None] * kv,
                             r[:, t].astype(jnp.float32)))
        s = w[:, t].astype(jnp.float32)[..., :, None] * s + kv
    return jnp.stack(os, 1), s


def test_kv_bf16_follows_the_reference_decode_arithmetic(rng):
    b, t, h, k = 2, 12, 2, 64
    bf16 = ml_dtypes.bfloat16
    r, kk, vv, w = (a.transpose(0, 2, 1, 3) for a in
                    _inputs(rng, (b, h), t, k, k, w_lo=0.9))
    r, kk, vv = (a.astype(bf16) for a in (r, kk, vv))
    u = (rng.standard_normal((h, k)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((b, h, k, k)).astype(np.float32)
    jo, js = _decode_wkv_reference(*map(jnp.asarray, (r, kk, vv, w, u, s0)))
    tr, tk, tv, tw = (interop._to_torch(a).transpose(1, 2)
                      for a in (r, kk, vv, w))
    tu, ts0 = _t(u, s0)
    o, s = trk.rwkv6_recurrence(tr, tk, tv, tw, tu, ts0, kv_bf16=True)
    eo, es, otol, stol = trk.wkv_tolerance(tr, tk, tv, tw, tu, ts0,
                                           kv_bf16=True)
    assert o.dtype == torch.bfloat16
    _within(o.float(), eo, otol, "port o")
    _within(s, es, stol, "port S")
    jo_f32 = torch.from_numpy(np.array(jo)).transpose(1, 2).double()
    _within(jo_f32, eo, otol - 2.0 ** -8 * eo.abs(), "reference o")
    _within(js, es, stol, "reference S")
    # the default (the TPU kernel's exact kv) is a different function
    _, s_exact = trk.rwkv6_recurrence(tr, tk, tv, tw, tu, ts0)
    assert ((s_exact.double() - es).abs() > stol).any()


def test_empty_sequence_returns_the_initial_state():
    r = torch.zeros(2, 3, 0, 8)
    s0 = torch.randn(2, 3, 8, 8)
    o, s = trk.rwkv6_recurrence(r, r, r, r, torch.zeros(3, 8), s0)
    assert o.shape == (2, 3, 0, 8) and torch.equal(s, s0)


# ---------------------------------------------------------------------------
# the CUDA kernel's lane split and summation order (the kernel itself runs
# only on the card; chip_smoke.py holds it to wkv_tolerance there)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [{}, {"groups": 4, "cpt": 1},
                                   {"groups": 16, "cpt": 4}, {"vcols": 32}],
                         ids=["shipped", "g4_c1", "g16_c4", "v32"])
@pytest.mark.parametrize("k,v", [(64, 64), (40, 24), (64, 56), (8, 8),
                                 (16, 16), (32, 32), (1, 1), (17, 64)])
def test_wkv_launch_shape_covers_every_state_lane_once(k, v, shape):
    """Whole warps, groups that divide a warp, 4-row loads, and every
    (row, column) of a (batch, head)'s state held by exactly one thread."""
    sh = trk.launch_shape(k, v, **shape)
    assert sh["threads"] % 32 == 0 and 32 % sh["groups"] == 0
    assert sh["rows"] % 4 == 0 and sh["kp"] == sh["groups"] * sh["rows"]
    assert sh["kp"] >= k and sh["blocks"] * sh["vcols"] >= v
    held = [lane for blk in trk.lanes(k, v, **shape) for th in blk
            for lane in th]
    assert sorted(held) == [(i, j) for i in range(k) for j in range(v)]


def _fma(a, b, c):
    """a·b + c rounded to f32 once from float64 (a·b of f32 values is exact
    there; the float64 sum rounds first, a double rounding a fused
    multiply-add does not make, well inside the bound)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _kernel_order(r, k, v, w, u, s0, *, kv_bf16):
    """The recurrence in f32 in ``csrc/rwkv6_recurrence.cu``'s order, with
    its lane split (:func:`trk.launch_shape`): K padded with zero rows; lane
    g of a column holds rows 4 (g + G m) + q and sums its terms into two
    partial sums (even and odd q, rows in order), one fused multiply-add a
    row; the G lanes' sums of a column are added in a pairwise tree."""
    K, V = r.shape[-1], v.shape[-1]
    sh = trk.launch_shape(K, V)
    G, kp, M = sh["groups"], sh["kp"], sh["rows"] // 4
    padk = [(0, 0)] * (r.ndim - 1) + [(0, kp - K)]
    r, k, w = (np.pad(x, padk) for x in (r, k, w))
    u = np.pad(u, [(0, 0), (0, kp - K)])
    S = np.zeros(r.shape[:-2] + (kp, V), np.float32)
    S[..., :K, :] = s0
    os = []
    for t in range(r.shape[-2]):
        kv = (k[..., t, :, None] * v[..., t, None, :]).astype(np.float32)
        if kv_bf16:
            kv = kv.astype(ml_dtypes.bfloat16).astype(np.float32)
        acc = [np.zeros(r.shape[:-2] + (G, V), np.float32) for _ in range(2)]
        for m in range(M):
            for q in range(4):
                i = 4 * (np.arange(G) + G * m) + q
                tt = _fma(u[:, i, None], kv[..., i, :], S[..., i, :])
                acc[q & 1] = _fma(r[..., t, i, None], tt, acc[q & 1])
                S[..., i, :] = _fma(w[..., t, i, None], S[..., i, :],
                                    kv[..., i, :])
        part = acc[0] + acc[1]
        d = 1
        while d < G:
            part[..., ::2 * d, :] = part[..., ::2 * d, :] + part[..., d::2 * d, :]
            d *= 2
        os.append(part[..., 0, :])
    return np.stack(os, -2), S[..., :K, :]


@pytest.mark.parametrize("kv_bf16", [False, True])
@pytest.mark.parametrize("h,t,k,v", SWEEP + [(1, 200, 8, 8), (3, 77, 40, 24),
                                             (2, 9, 64, 56), (8, 1, 64, 40)])
def test_kernel_summation_order_within_wkv_tolerance(rng, h, t, k, v,
                                                     kv_bf16):
    """The kernel's order (split over k by lane, then the tree over lanes),
    emulated in f32 from a state, stays within ``wkv_tolerance`` of the
    float64 recurrence over the reference sweep and the lane split's edges
    (K and V off the split, a decode at V < 64)."""
    r, kk, vv, w = _inputs(rng, (h,), t, k, v)
    u = (rng.standard_normal((h, k)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((h, k, v)).astype(np.float32)
    o, s = _kernel_order(r, kk, vv, w, u, s0, kv_bf16=kv_bf16)
    eo, es, otol, stol = trk.wkv_tolerance(*_t(r, kk, vv, w, u, s0),
                                           kv_bf16=kv_bf16)
    _within(o, eo, otol, "o")
    _within(s, es, stol, "S")


# ---------------------------------------------------------------------------
# the serving block: rwkv6_decode / rwkv6_prefill vs the reference's decode
# ---------------------------------------------------------------------------

D = 128


def _block(dtype):
    """One block's params from the reference's own init (seeded), and the
    same params on the port's side."""
    k1, k2 = jax.random.split(jax.random.key(3))
    jp = {"tok": JR.init_rwkv6(k1, D, dtype),
          "ch": JR.init_channel_mix(k2, D, 256, dtype),
          "ln1": JL.init_rmsnorm(D), "ln2": JL.init_rmsnorm(D)}
    jp["ln1"]["scale"] = jp["ln1"]["scale"] * 1.25
    return jp, interop.params_from_reference(jp)


def _cache(rng, b, dtype, zero: bool):
    c = {"s": np.zeros((b, D // 64, 64, 64), np.float32),
         "x_tok": np.zeros((b, D), np.float32),
         "x_ch": np.zeros((b, D), np.float32)}
    if not zero:
        c = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in c.items()}
    if dtype == jnp.bfloat16:
        c["x_tok"] = c["x_tok"].astype(ml_dtypes.bfloat16)
        c["x_ch"] = c["x_ch"].astype(ml_dtypes.bfloat16)
    return c


def _reference_steps(jp, x, cache):
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    step = jax.jit(lambda xx, cc: JR.rwkv6_decode(
        jp["tok"], jp["ch"], xx, cc, lambda z: JL.rmsnorm(jp["ln1"], z),
        lambda z: JL.rmsnorm(jp["ln2"], z)))
    outs = []
    for t in range(x.shape[1]):
        y, jc = step(jnp.asarray(x[:, t:t + 1]), jc)
        outs.append(np.asarray(y, np.float32))
    return np.concatenate(outs, 1), {k: np.asarray(v, np.float32)
                                     for k, v in jc.items()}


def _port(tp, x, cache, *, decode: bool):
    tc = interop.cache_from_reference(cache)
    norms = (lambda z: TL.rmsnorm(tp["ln1"], z),
             lambda z: TL.rmsnorm(tp["ln2"], z))
    tx = interop._to_torch(x)
    if decode:
        ys = []
        for t in range(tx.shape[1]):
            y, tc = TR.rwkv6_decode(tp["tok"], tp["ch"], tx[:, t:t + 1], tc,
                                    *norms)
            ys.append(y)
        y = torch.cat(ys, 1)
    else:
        y, tc = TR.rwkv6_prefill(tp["tok"], tp["ch"], tx, tc, *norms)
    return y.float().numpy(), {k: v.float().numpy() for k, v in tc.items()}


def _close(got, want, dtype, what):
    scale = np.abs(want).max()
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=what)
    else:
        tol = 2.0 ** -7 if what == "s" else 2.0 ** -6
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                                   err_msg=what)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["decode", "prefill"])
@pytest.mark.parametrize("zero", [True, False], ids=["zero", "carried"])
def test_block_matches_reference_decode_steps(rng, dtype, mode, zero):
    """``rwkv6_decode`` stepped, and ``rwkv6_prefill`` in one call, against
    T jitted calls of the reference's ``rwkv6_decode``, from a zero and
    from a carried (random) cache: outputs and every cache leaf."""
    jp, tp = _block(dtype)
    b, t = 2, 9
    x = rng.standard_normal((b, t, D)).astype(np.float32)
    if dtype == jnp.bfloat16:
        x = x.astype(ml_dtypes.bfloat16)
    cache = _cache(rng, b, dtype, zero)
    want_y, want_c = _reference_steps(jp, x, cache)
    got_y, got_c = _port(tp, x, cache, decode=mode == "decode")
    _close(got_y, want_y, dtype, "x")
    for k in want_c:
        _close(got_c[k], want_c[k], dtype, k)


def test_decode_updates_the_cache_in_place(rng):
    _, tp = _block(jnp.float32)
    tc = interop.cache_from_reference(_cache(rng, 2, jnp.float32, False))
    ptrs = {k: v.data_ptr() for k, v in tc.items()}
    before = {k: v.clone() for k, v in tc.items()}
    x = torch.randn(2, 1, D)
    _, out = TR.rwkv6_decode(tp["tok"], tp["ch"], x, tc,
                             lambda z: TL.rmsnorm(tp["ln1"], z),
                             lambda z: TL.rmsnorm(tp["ln2"], z))
    assert out is tc
    for k, v in tc.items():
        assert v.data_ptr() == ptrs[k] and not torch.equal(v, before[k])
    with pytest.raises(ValueError, match="one token"):
        TR.rwkv6_decode(tp["tok"], tp["ch"], torch.randn(2, 3, D), tc,
                        lambda z: z, lambda z: z)
