"""repro_torch error-feedback compressed all-reduce against the JAX reference.

One seeded numpy input goes to ``repro.core.lookaside`` under
``jax.shard_map`` on 8 host devices and to ``repro_torch.core.lookaside``
on ``LocalMesh({"data": 8}, device="cpu")``, for the three compressors.
The port runs the reference's operations one rounding at a time, and
``topk`` is bitwise on any data.  The int8 compressors meet two XLA
rewrites in the jitted reference, each named and shown by a test here:

  * **the scale.** XLA's algebraic simplifier turns ``absmax / 127.0``
    into ``absmax * float32(1/127)``: the reference's block scale can be
    one f32 rounding off the port's IEEE division, so a lane near a
    rounding tie may quantize one int8 step apart.
  * **the hop combine** (``int8_hopquant``): XLA contracts ``q·s + q·s``
    into one fused multiply-add (ROADMAP.md §3), where the port rounds
    the products first.

On *planted* data — every 256-lane block peaks at exactly ``127·2^k`` —
both rewrites are exact (the scale is ``2^k`` either way, and every
product of a hop is exact), so all three compressors are bitwise.  On
random data the int8 compressors compare within one quantization step
``s = max|x|/127`` per rank contribution: what a rank delivered differs
by at most ``s``, the ``int8`` total by ``n·s``, and the ``int8_hopquant``
total additionally by ``(n-1)·M/127`` (each hop requantizes within half a
step of ``M/127``, ``M`` the largest sum of |contributions| over the
ranks), plus one rounding of the output dtype.

Then the reference's own EF tests, ported: the EF identity over 12 steps
and every rank holding the same result.  ``use_kernels=True`` runs the
kernels' plain versions here (CPU tensors) and must change nothing.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import lookaside as jla
from repro_torch.core import lookaside as tla
from repro_torch.interop import tree_ranks_from_reference
from repro_torch.mesh import LocalMesh

N = 8
COMPRESSORS = ["int8", "int8_hopquant", "topk"]
NP_DT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def smap(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def assert_bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def _spec(x):
    return P("data", *([None] * (x.ndim - 1)))


def planted(rng, shape, np_dt, k=-5):
    """Data on which the int8 compressors are exact in both frameworks:
    lane 0, every 50th lane and the last lane of each rank hold
    ``127·2^k``, the rest lie within ``126·2^k``, so every 256-lane block
    of any layout peaks at ``127·2^k`` and its scale is ``2^k``."""
    top = 127 * 2.0 ** k
    x = np.clip(rng.standard_normal(shape) * top / 3,
                -(top - 2.0 ** k), top - 2.0 ** k).astype(np.float32)
    flat = x.reshape(shape[0], -1)
    flat[:, ::50] = top
    flat[:, -1] = top
    return x.astype(np_dt)


def int8_tolerance(x: np.ndarray, compressor: str, want: np.ndarray,
                   dtype: str) -> tuple[float, np.ndarray]:
    """(delivered, total) tolerances on random data, as stated above."""
    xf = np.abs(x.astype(np.float32))
    s = float(xf.max()) / 127
    total = N * s
    if compressor == "int8_hopquant":
        total += (N - 1) * float(xf.sum(axis=0).max()) / 127
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -23
    return s, total + ulp * np.abs(want.astype(np.float32))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("data", ["planted", "random"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_compressed_all_reduce_matches_reference(mesh8, rng, compressor,
                                                 dtype, data, use_kernels):
    if data == "planted":
        x = planted(rng, (N, 7, 90), NP_DT[dtype])
    else:
        x = (rng.standard_normal((N, 7, 90)) * 3.0).astype(np.float32) \
            .astype(NP_DT[dtype])

    def ref(xl):
        tot, dlv = jla.compressed_all_reduce(xl[0], "data",
                                             compressor=compressor,
                                             topk_ratio=0.05)
        return tot[None], dlv[None]

    spec = _spec(x)
    wt, wd = smap(ref, mesh8, spec, (spec, spec))(jnp.asarray(x))
    with LocalMesh({"data": N}, device="cpu"):
        tt, td = tla.compressed_all_reduce(_t(x), "data",
                                           compressor=compressor,
                                           topk_ratio=0.05,
                                           use_kernels=use_kernels)
    assert tt.dtype == _t(x).dtype and td.dtype == torch.float32
    if data == "planted" or compressor == "topk":
        assert_bitwise(_np(td), np.asarray(wd))
        assert_bitwise(_np(tt), np.asarray(wt))
        return
    wt = np.asarray(wt)
    tol_d, tol_t = int8_tolerance(x, compressor, wt, dtype)
    assert np.all(np.abs(td.numpy() - np.asarray(wd)) <= tol_d)
    assert np.all(np.abs(_np(tt).astype(np.float32)
                         - wt.astype(np.float32)) <= tol_t)


def test_reference_scale_is_a_reciprocal_multiply(mesh8, rng):
    """The scale rewrite, shown: on random bf16 data the jitted
    reference's ``int8`` delivered value is bitwise the model that scales
    by ``absmax * float32(1/127)``, and the port's is bitwise the model
    that divides — and the two models differ on this input."""
    x = (rng.standard_normal((N, 7, 90)) * 3.0).astype(np.float32) \
        .astype(ml_dtypes.bfloat16)

    def ref(xl):
        return jla.compressed_all_reduce(xl[0], "data")[1][None]

    spec = _spec(x)
    wd = np.asarray(smap(ref, mesh8, spec, spec)(jnp.asarray(x)))
    with LocalMesh({"data": N}, device="cpu"):
        _, td = tla.compressed_all_reduce(_t(x), "data")
    flat = np.zeros((N, 3 * 256), np.float32)
    flat[:, :630] = x.astype(np.float32).reshape(N, -1)
    blocks = flat.reshape(N, 3, 256)
    absmax = np.abs(blocks).max(axis=(0, 2))      # shared over the ranks

    def model(scale):
        q = np.clip(np.round(blocks / scale[None, :, None]), -127, 127)
        q = q.astype(np.int16).astype(np.float32)          # no -0.0 lanes
        return (q * scale[None, :, None]).reshape(N, -1)[:, :630] \
            .reshape(x.shape).astype(np.float32)

    by_div = (absmax / np.float32(127)).astype(np.float32)
    by_rcp = (absmax * np.float32(1 / 127)).astype(np.float32)
    assert np.any(by_div != by_rcp)
    assert_bitwise(wd, model(by_rcp))
    assert_bitwise(td.numpy(), model(by_div))


def test_planted_scales_are_exact_either_way():
    """Why the planted data is bitwise: ``127·m·2^k / 127`` and
    ``127·m·2^k * float32(1/127)`` are both ``m·2^k`` for every partial
    sum of m <= 8 ranks."""
    for m in range(1, N + 1):
        for k in (-5, 0, 3):
            top = np.float32(127 * m * 2.0 ** k)
            want = np.float32(m * 2.0 ** k)
            assert top / np.float32(127) == want
            assert np.float32(top * np.float32(1 / 127)) == want


@pytest.mark.parametrize("data", ["planted", "random"])
@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_error_feedback_all_reduce_matches_reference(mesh8, rng, compressor,
                                                     data):
    if data == "planted":
        x = planted(rng, (N, 300), np.float32)
        r0 = np.zeros((N, 300), np.float32)
    else:
        x = rng.standard_normal((N, 300)).astype(np.float32)
        r0 = (rng.standard_normal((N, 300)) * 0.01).astype(np.float32)

    def ref(xl, rl):
        red, res = jla.error_feedback_all_reduce(
            xl[0], rl[0], "data", compressor=compressor, topk_ratio=0.05)
        return red[None], res[None]

    spec = _spec(x)
    wr, ws = smap(ref, mesh8, (spec, spec), (spec, spec))(
        jnp.asarray(x), jnp.asarray(r0))
    with LocalMesh({"data": N}, device="cpu"):
        tr, ts = tla.error_feedback_all_reduce(
            _t(x), _t(r0), "data", compressor=compressor, topk_ratio=0.05)
    if data == "planted" or compressor == "topk":
        assert_bitwise(ts.numpy(), np.asarray(ws))
        assert_bitwise(tr.numpy(), np.asarray(wr))
        return
    # residual = target - delivered; the mean divides the total by n
    tol_d, tol_t = int8_tolerance(x + r0, compressor, np.asarray(wr),
                                  "float32")
    assert np.all(np.abs(ts.numpy() - np.asarray(ws)) <= tol_d)
    assert np.all(np.abs(tr.numpy() - np.asarray(wr)) <= tol_t / N)


def test_shared_scale_quant_all_reduce_matches_reference(mesh8, rng):
    x = rng.standard_normal((N, 3, 129)).astype(np.float32)

    def ref(xl):
        tot, dlv = jla.shared_scale_quant_all_reduce(xl[0], "data")
        return tot[None], dlv[None]

    spec = _spec(x)
    wt, wd = smap(ref, mesh8, spec, (spec, spec))(jnp.asarray(x))
    with LocalMesh({"data": N}, device="cpu"):
        tt, td = tla.shared_scale_quant_all_reduce(_t(x), "data")
    assert_bitwise(tt.numpy(), np.asarray(wt))
    assert_bitwise(td.numpy(), np.asarray(wd))
    # the integer ring is exact: the total is the sum of what was delivered
    np.testing.assert_allclose(tt.numpy()[0], td.numpy().sum(0), rtol=1e-6,
                               atol=1e-5)


def test_unknown_compressor_raises(rng):
    with LocalMesh({"data": N}, device="cpu"):
        with pytest.raises(ValueError, match="unknown compressor"):
            tla.compressed_all_reduce(torch.zeros(N, 4), "data",
                                      compressor="zstd")


def test_init_residual_is_f32_zeros_like_the_tree():
    g = {"w": torch.ones(N, 3, 2, dtype=torch.bfloat16),
         "b": [torch.ones(N, 5)]}
    r = tla.init_residual(g)
    assert r["w"].dtype == torch.float32 and tuple(r["w"].shape) == (N, 3, 2)
    assert float(r["w"].abs().sum() + r["b"][0].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# the reference's EF tests (tests/test_core_lookaside.py), ported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("compressor", ["int8", "topk"])
def test_error_feedback_identity(rng, compressor, use_kernels):
    """The exact EF invariant: over T steps,
        cum_true_mean - cum_synced == mean_over_ranks(final_residual)
    i.e. *nothing is lost* — whatever the lossy wire withheld is still in
    the look-aside memory, to be delivered later."""
    steps, dim = 12, 256
    grads = rng.standard_normal((steps, N, dim)).astype(np.float32)
    with LocalMesh({"data": N}, device="cpu"):
        res = torch.zeros(N, dim)
        outs = []
        for s in range(steps):
            red, res = tla.error_feedback_all_reduce(
                torch.from_numpy(grads[s]), res, "data",
                compressor=compressor, topk_ratio=0.05,
                use_kernels=use_kernels)
            outs.append(red.numpy())
    out, res = np.stack(outs), res.numpy()
    cum_true = np.cumsum(grads.mean(axis=1), axis=0)[-1]
    cum_got = np.cumsum(out[:, 0, :], axis=0)[-1]
    np.testing.assert_allclose(cum_true - cum_got, res.mean(axis=0),
                               rtol=2e-2, atol=2e-2)
    # and for int8 (dense quantization) the residual itself must be tiny:
    if compressor == "int8":
        lsb = np.abs(grads).max() / 127
        assert np.abs(res).max() < 4 * lsb


@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_error_feedback_all_ranks_identical(rng, compressor):
    """The RS∘AG rings fold every chunk along one walk, so every rank
    decodes the same total.  The sparse ring adds in a rank-relative
    order: its ranks agree to f32 rounding."""
    g = rng.standard_normal((N, 300)).astype(np.float32)
    with LocalMesh({"data": N}, device="cpu"):
        red, _ = tla.error_feedback_all_reduce(
            torch.from_numpy(g), torch.zeros(N, 300), "data",
            compressor=compressor)
    out = red.numpy()
    for i in range(1, N):
        if compressor == "topk":
            np.testing.assert_allclose(out[i], out[0], rtol=0,
                                       atol=N * 2.0 ** -23
                                       * np.abs(g).sum(0).max())
        else:
            np.testing.assert_array_equal(out[i], out[0])


def test_residual_state_carries_from_the_reference(mesh8, rng):
    """Step 1 in JAX, step 2 in the port on the reference's residual:
    a residual is a pytree of rank-sharded arrays, which
    ``tree_ranks_from_reference`` carries over unchanged."""
    g1, g2 = (planted(rng, (N, 200), np.float32) for _ in range(2))

    def ref(xl, rl):          # residual rank-local [200], global [N * 200]
        red, res = jla.error_feedback_all_reduce(xl[0], rl, "data")
        return red[None], res

    spec = _spec(g1)
    step = smap(ref, mesh8, (spec, P("data")), (spec, P("data")))
    _, r1 = step(jnp.asarray(g1), jnp.zeros((N * 200,), jnp.float32))
    w2, wr2 = step(jnp.asarray(g2), r1)
    mesh = LocalMesh({"data": N}, device="cpu")
    res = tree_ranks_from_reference({"r": np.asarray(r1)}, mesh)
    assert tuple(res["r"].shape) == (N, 200)
    with mesh:
        t2, tr2 = tla.error_feedback_all_reduce(
            torch.from_numpy(g2), res["r"], "data")
    assert_bitwise(t2.numpy(), np.asarray(w2))
    assert_bitwise(tr2.numpy().reshape(-1), np.asarray(wr2))


# ---------------------------------------------------------------------------
# distributed prefix sum (the Fig. 5 FEM op)
#
# jnp.cumsum on the CPU is an associative scan and the port's plain
# prefix_sum sums in order: integer-valued data (every partial sum exact)
# is bitwise, random floats are held within the worst-case rounding of a
# prefix sum in any order, i·2^-24·Σ_{t≤i}|x_t| on each side.
# ---------------------------------------------------------------------------

def _global_scan_bound(x: np.ndarray) -> np.ndarray:
    """``x`` is [ranks, T, ...]; the bound for the scan of the rank-major
    concatenation, in the same shape."""
    flat = np.abs(x.astype(np.float64)).reshape((-1,) + x.shape[2:])
    i = np.arange(1, flat.shape[0] + 1).reshape((-1,) + (1,) * (x.ndim - 2))
    return (i * 2.0 ** -24 * np.cumsum(flat, axis=0)).reshape(x.shape)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("local", [(16,), (16, 3), (0,), (0, 3)])
def test_distributed_prefix_sum_matches_reference(mesh8, rng, local,
                                                  exclusive, use_kernels):
    """Bitwise on integer-valued data, the empty block included: an
    exclusive scan of an empty block still yields its carry row, as the
    reference's ``concat([carry[None], inc[:-1]])`` does."""
    x = rng.integers(-5, 6, (N,) + local).astype(np.float32)

    def ref(xl):
        return jla.distributed_prefix_sum(xl[0], "data",
                                          exclusive=exclusive)[None]

    spec = _spec(x)
    want = np.asarray(smap(ref, mesh8, spec, spec)(jnp.asarray(x)))
    with LocalMesh({"data": N}, device="cpu"):
        got = tla.distributed_prefix_sum(_t(x), "data", exclusive=exclusive,
                                         use_kernels=use_kernels)
    assert_bitwise(got.numpy(), want)
    if local[0]:
        flat = np.cumsum(x.reshape((-1,) + local[1:]).astype(np.float64), 0)
        if exclusive:
            flat = np.concatenate([np.zeros((1,) + local[1:]), flat[:-1]])
        np.testing.assert_array_equal(got.numpy().reshape(flat.shape), flat)
    else:
        assert got.shape == (N, int(exclusive)) + local[1:]


def test_distributed_prefix_sum_random_within_rounding(mesh8, rng):
    x = rng.standard_normal((N, 64, 2)).astype(np.float32)

    def ref(xl):
        return jla.distributed_prefix_sum(xl[0], "data")[None]

    spec = _spec(x)
    want = np.asarray(smap(ref, mesh8, spec, spec)(jnp.asarray(x)))
    with LocalMesh({"data": N}, device="cpu"):
        got = tla.distributed_prefix_sum(_t(x), "data").numpy()
    bound = _global_scan_bound(x)
    exact = np.cumsum(x.reshape(-1, 2).astype(np.float64), 0).reshape(x.shape)
    assert np.all(np.abs(got - want) <= 2 * bound)
    assert np.all(np.abs(got - exact) <= bound)


def test_prefix_sum_scans_the_local_dim_not_the_ranks(rng):
    """The local scan runs along the first *local* dim: on rank-stacked
    data dim 0 is the rank dim, and scanning it (the plain op's default
    dim) would sum across ranks — a different, wrong answer on this
    input."""
    from repro_torch.core import switchops

    x = torch.from_numpy(rng.integers(-5, 6, (N, 6)).astype(np.float32))
    with LocalMesh({"data": N}, device="cpu"):
        got = tla.distributed_prefix_sum(x, "data")
    want = torch.cumsum(x.reshape(-1), 0).reshape(N, 6)
    assert torch.equal(got, want)
    local = switchops.get("prefix_sum")(x, dim=1)
    assert torch.equal(local, torch.cumsum(x, 1))
    across = switchops.get("prefix_sum")(x)           # dim 0: the ranks
    carry = torch.cat([torch.zeros(1), torch.cumsum(x[:, -1], 0)[:-1]])
    assert not torch.equal(across + carry[:, None], want)


# ---------------------------------------------------------------------------
# GCN aggregation (paper Fig. 4 case study)
# ---------------------------------------------------------------------------

def _random_graph(rng, n_nodes, d):
    adj = (rng.random((n_nodes, n_nodes)) < 0.2).astype(np.float32)
    deg = np.maximum(adj.sum(1, keepdims=True), 1)
    adj = adj / deg                      # row-normalized Â
    x = rng.standard_normal((n_nodes, d)).astype(np.float32)
    return adj, x


@pytest.mark.parametrize("in_network", [True, False])
def test_gcn_aggregate_matches_reference(mesh8, rng, in_network):
    """Both modes against the reference and the dense product; block
    MACs sum their products in another order than XLA's dot, so they are
    held within the reference test's tolerance."""
    n_nodes, d = N * 8, 12
    adj, x = _random_graph(rng, n_nodes, d)
    rows = n_nodes // N
    # adj_blocks[rank][b] = adj rows of `rank`, cols of block b
    adj_blocks = adj.reshape(N, rows, N, rows).transpose(0, 2, 1, 3).copy()
    xs = x.reshape(N, rows, d)

    def ref(al, xl):
        return jla.gcn_aggregate(al[0], xl[0], "data",
                                 in_network=in_network)[None]

    want = np.asarray(smap(ref, mesh8, (_spec(adj_blocks), _spec(xs)),
                           _spec(xs))(jnp.asarray(adj_blocks),
                                      jnp.asarray(xs)))
    with LocalMesh({"data": N}, device="cpu"):
        got = tla.gcn_aggregate(_t(adj_blocks), _t(xs), "data",
                                in_network=in_network).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.reshape(n_nodes, d), adj @ x,
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# PowerSGD (the in-collective loop)
#
# Matmuls and Gram-Schmidt norms sum in another order than XLA's, so the
# port is held within 1e-4 of the reference, relative to each output's
# largest entry.  q comes from numpy: torch.Generator does not give
# jax.random's bits.
# ---------------------------------------------------------------------------

def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("steps", [1, 3])
def test_powersgd_matches_reference(mesh8, rng, steps):
    """One step, and three with q and the residual threaded."""
    rows, cols, r = 24, 16, 3
    ms = rng.standard_normal((steps, N, rows, cols)).astype(np.float32)
    q0 = rng.standard_normal((cols, r)).astype(np.float32)

    def ref(ml, q, res):
        red, new_q, new_res = jla.powersgd_all_reduce(ml[0], q, res[0],
                                                      "data")
        return red[None], new_q, new_res[None]

    step = smap(ref, mesh8, (P("data", None, None), P(None, None),
                             P("data", None, None)),
                (P("data", None, None), P(None, None),
                 P("data", None, None)))
    jq, jres = jnp.asarray(q0), jnp.zeros((N, rows, cols), jnp.float32)
    tq = torch.from_numpy(q0).expand(N, cols, r)
    tres = torch.zeros(N, rows, cols)
    for s in range(steps):
        jred, jq, jres = step(jnp.asarray(ms[s]), jq, jres)
        with LocalMesh({"data": N}, device="cpu"):
            tred, tq, tres = tla.powersgd_all_reduce(
                torch.from_numpy(ms[s]), tq, tres, "data")
        _close(tred.numpy(), jred)
        _close(tres.numpy(), jres)
        for i in range(N):           # the reduced factors agree everywhere
            _close(tq.numpy()[i], jq)
            assert torch.equal(tred[i], tred[0])


def test_powersgd_low_rank_exact_for_low_rank_input(rng):
    """If the true mean gradient is rank<=r, one power iteration with a
    warm Q recovers it (up to orthonormalization conditioning) — the
    reference test's case and tolerance."""
    rows, cols, r = 32, 16, 4
    u = rng.standard_normal((rows, r)).astype(np.float32)
    v = rng.standard_normal((cols, r)).astype(np.float32)
    base = u @ v.T
    m = torch.from_numpy(np.broadcast_to(base, (N, rows, cols)).copy())
    q0 = torch.from_numpy(rng.standard_normal((cols, r)).astype(np.float32))
    with LocalMesh({"data": N}, device="cpu"):
        red, new_q, _ = tla.powersgd_all_reduce(
            m, q0.expand(N, cols, r), torch.zeros(N, rows, cols), "data")
    assert tuple(new_q.shape) == (N, cols, r)
    np.testing.assert_allclose(red.numpy()[0], base, rtol=0.03,
                               atol=0.03 * np.abs(base).max())


def test_powersgd_init_draws_from_the_generator():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = tla.powersgd_init((32, 16), 4, g1)
    assert tuple(a.shape) == (16, 4) and a.dtype == torch.float32
    assert torch.equal(a, tla.powersgd_init((32, 16), 4, g2))


# ---------------------------------------------------------------------------
# look-aside ops routed through engine.compile.  The port's map bodies get
# rank-stacked tensors, so where the reference's body indexes its local
# leading dim (`ab[0]`, `[None]`) the port's indexes the one after the rank
# dim (`ab[:, 0]`, `.unsqueeze(1)`).  Both packages place these map
# bodies as host fallbacks (tests/test_torch_mapper.py).
# ---------------------------------------------------------------------------

def test_distributed_prefix_sum_through_engine_compile(mesh8, rng):
    from repro import core as jacis
    from repro_torch import core as tacis
    from repro_torch.mesh import P as TP

    x = rng.integers(-5, 6, (N * 16,)).astype(np.float32)
    jfn = jacis.make_engine("acis").compile(
        lambda v: jacis.map(
            lambda b: jla.distributed_prefix_sum(b, "data"), v,
            name="prefix_sum", fusable=False),
        mesh8, P("data"), P("data"),
        in_avals=(jax.ShapeDtypeStruct((16,), jnp.float32),))
    tfn = tacis.make_engine("acis").compile(
        lambda v: tacis.map(
            lambda b: tla.distributed_prefix_sum(b, "data"), v,
            name="prefix_sum", fusable=False),
        LocalMesh({"data": N}, device="cpu"), TP("data"), TP("data"),
        in_avals=(tacis.TensorSpec((16,), torch.float32),))
    assert tfn.stages == jfn.stages == ["map"]
    got = tfn(torch.from_numpy(x)).numpy()
    assert_bitwise(got, np.asarray(jfn(jnp.asarray(x))))
    np.testing.assert_array_equal(got, np.cumsum(x))


def test_gcn_aggregate_through_engine_compile(mesh8, rng):
    from repro import core as jacis
    from repro_torch import core as tacis
    from repro_torch.mesh import P as TP

    n_nodes, d = N * 8, 12
    adj, x = _random_graph(rng, n_nodes, d)
    rows = n_nodes // N
    adj_blocks = adj.reshape(N, rows, N, rows).transpose(0, 2, 1, 3).copy()
    xs = x.reshape(N, rows, d)
    jfn = jacis.make_engine("acis").compile(
        lambda a, v: jacis.map(
            lambda ab, xb: jla.gcn_aggregate(ab[0], xb[0], "data")[None],
            a, v, name="gcn_aggregate"),
        mesh8, (P("data", None, None, None), P("data", None, None)),
        P("data", None, None),
        in_avals=(jax.ShapeDtypeStruct((1, N, rows, rows), jnp.float32),
                  jax.ShapeDtypeStruct((1, rows, d), jnp.float32)))
    tfn = tacis.make_engine("acis").compile(
        lambda a, v: tacis.map(
            lambda ab, xb: tla.gcn_aggregate(ab[:, 0], xb[:, 0],
                                             "data").unsqueeze(1),
            a, v, name="gcn_aggregate"),
        LocalMesh({"data": N}, device="cpu"),
        (TP("data", None, None, None), TP("data", None, None)),
        TP("data", None, None),
        in_avals=(tacis.TensorSpec((1, N, rows, rows), torch.float32),
                  tacis.TensorSpec((1, rows, d), torch.float32)))
    assert tfn.stages == jfn.stages == ["map"]
    got = tfn(torch.from_numpy(adj_blocks), torch.from_numpy(xs)).numpy()
    want = np.asarray(jfn(jnp.asarray(adj_blocks), jnp.asarray(xs)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.reshape(n_nodes, d), adj @ x,
                               rtol=1e-4, atol=1e-4)


def test_gcn_baseline_through_engine_compile_matches(mesh8, rng):
    from repro import core as jacis
    from repro_torch import core as tacis
    from repro_torch.mesh import P as TP

    n_nodes, d = N * 4, 6
    adj, x = _random_graph(rng, n_nodes, d)
    rows = n_nodes // N
    adj_blocks = adj.reshape(N, rows, N, rows).transpose(0, 2, 1, 3).copy()
    xs = x.reshape(N, rows, d)

    def jprog(a, v):
        gathered = jacis.all_gather(v)
        return jacis.map(
            lambda ab, full: jnp.einsum(
                "brc,bcd->rd", ab[0], full.reshape(N, rows, d))[None],
            a, gathered, name="spmm")

    def tprog(a, v):
        gathered = tacis.all_gather(v)
        return tacis.map(
            lambda ab, full: torch.einsum(
                "...brc,...bcd->...rd", ab[:, 0],
                full.reshape(-1, N, rows, d)).unsqueeze(1),
            a, gathered, name="spmm")

    jfn = jacis.make_engine("acis").compile(
        jprog, mesh8, (P("data", None, None, None), P("data", None, None)),
        P("data", None, None))
    tfn = tacis.make_engine("acis").compile(
        tprog, LocalMesh({"data": N}, device="cpu"),
        (TP("data", None, None, None), TP("data", None, None)),
        TP("data", None, None))
    assert tfn.stages == jfn.stages
    got = tfn(torch.from_numpy(adj_blocks), torch.from_numpy(xs)).numpy()
    want = np.asarray(jfn(jnp.asarray(adj_blocks), jnp.asarray(xs)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.reshape(n_nodes, d), adj @ x,
                               rtol=1e-4, atol=1e-4)
