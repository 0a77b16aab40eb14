"""repro_torch CollectiveEngine end to end against the JAX reference.

``gradient_sync`` on a small mixed f32/bf16 gradient pytree: one seeded
numpy input, the reference under ``jax.shard_map`` on 8 host devices
(Pallas kernels in interpret mode when ``use_kernels=True``), the port on
``LocalMesh({"data": 8}, device="cpu")``.  f32 leaves must match
bitwise; bf16 leaves too, since every ring add rounds once in both
frameworks and the mean divides by a power of two.  ``use_kernels`` is set
explicitly on both sides.

``acis_compressed`` runs 3 steps with the error-feedback residuals
threaded through, for each compressor.  On planted f32 gradients (every 256-lane
block peaks at exactly ``127·2^k``, see ``test_torch_lookaside.py``)
outputs and residuals are bitwise for all three.  On random mixed
f32/bf16 gradients the jitted reference differs through three XLA
rewrites, each shown by a test: the scale's reciprocal multiply, the
hop's FMA, and excess precision for bf16 EF targets; the comparison is
then within the tolerance stated at ``_tolerance``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from repro import core as jacis
from repro_torch import core as tacis
from repro_torch import obs as tobs
from repro_torch.interop import (reference_from_ranks, ranks_from_reference,
                                 tree_ranks_from_reference,
                                 tree_reference_from_ranks)
from repro_torch.mesh import P, LocalMesh

N = 8
# local (per-rank) shapes and dtypes: ragged, mixed, several buckets
LEAVES = {
    "a": ((3, 5), np.float32),
    "b": ((1, 7), ml_dtypes.bfloat16),
    "c": ((2, 4, 3), np.float32),
    "d": ((4,), ml_dtypes.bfloat16),
    "e": ((5, 11), np.float32),
    "f": ((37, 40), np.float32),
}
JDT = {np.float32: jnp.float32, ml_dtypes.bfloat16: jnp.bfloat16}


def _grads(rng, leaves=LEAVES):
    """Global arrays the reference shards P("data"): [N * L0, ...]."""
    return {k: rng.standard_normal((N * s[0],) + s[1:]).astype(np.float32)
            .astype(dt) for k, (s, dt) in leaves.items()}


def ref_sync(mesh8, grads, *, backend="acis", use_kernels=False,
             arenas=False, **kw):
    eng = jacis.make_engine(backend, use_kernels=use_kernels, **kw)
    keys = sorted(grads)
    specs = tuple(JP("data", *([None] * (grads[k].ndim - 1))) for k in keys)
    local = {k: jnp.zeros(LEAVES[k][0], JDT[LEAVES[k][1]]) for k in keys}
    ar = eng.init_arenas(local, axis_sizes={"data": N}) if arenas else None

    def f(ar, *ls):
        g = dict(zip(keys, ls))
        if ar:
            synced, _, _ = eng.gradient_sync(g, None, arenas=tuple(ar))
        else:
            synced, _ = eng.gradient_sync(g, None)
        return tuple(synced[k] for k in keys)

    n_ar = len(ar) if ar is not None else 0
    fn = jax.jit(jax.shard_map(f, mesh=mesh8,
                               in_specs=((JP(),) * n_ar,) + specs,
                               out_specs=specs, check_vma=False))
    if ar is not None:
        ar = jax.device_put(tuple(ar), NamedSharding(mesh8, JP()))
    outs = fn(ar if ar is not None else (), *[jnp.asarray(grads[k])
                                              for k in keys])
    return {k: np.asarray(o) for k, o in zip(keys, outs)}


def port_sync(grads, *, backend="acis", use_kernels=False, arenas=False,
              steps=1, **kw):
    eng = tacis.make_engine(backend, use_kernels=use_kernels, **kw)
    mesh = LocalMesh({"data": N}, device="cpu")
    g = tree_ranks_from_reference(grads, mesh)
    with mesh:
        ar = eng.init_arenas(g) if arenas else None
        ptrs = [a.data_ptr() for a in ar] if ar else []
        for _ in range(steps):
            if ar is not None:
                synced, _, back = eng.gradient_sync(g, None, arenas=ar)
                assert back == tuple(ar)          # the same tensors
            else:
                synced, _ = eng.gradient_sync(g, None)
    if ar:
        assert [a.data_ptr() for a in ar] == ptrs  # written in place
    return {k: reference_from_ranks(v, mesh) for k, v in synced.items()}, \
        eng, ar


def assert_bitwise(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("bucket_bytes", [None, 256])
@pytest.mark.parametrize("arenas", [False, True])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_gradient_sync_matches_reference_bitwise(mesh8, rng, use_kernels,
                                                  arenas, bucket_bytes):
    grads = _grads(rng)
    want = ref_sync(mesh8, grads, use_kernels=use_kernels, arenas=arenas,
                    bucket_bytes=bucket_bytes)
    got, _, ar = port_sync(grads, use_kernels=use_kernels, arenas=arenas,
                           bucket_bytes=bucket_bytes)
    if arenas:
        assert ar is not None and len(ar) >= 1
    for k in sorted(grads):
        assert_bitwise(got[k], want[k])
        np.testing.assert_allclose(
            got[k].astype(np.float32)[:LEAVES[k][0][0]],
            grads[k].astype(np.float32).reshape(
                (N,) + LEAVES[k][0]).mean(0),
            rtol=2e-2, atol=2e-2)


def test_xla_backend_matches_reference(mesh8, rng):
    """The baseline sums over the rank dim in another order than XLA's
    psum: allclose (f32 1e-6; bf16 leaves at one bf16 ulp of 1, 8e-3)."""
    grads = _grads(rng)
    want = ref_sync(mesh8, grads, backend="xla")
    got, _, _ = port_sync(grads, backend="xla")
    for k in sorted(grads):
        tol = 1e-6 if LEAVES[k][1] == np.float32 else 8e-3
        np.testing.assert_allclose(got[k].astype(np.float32),
                                   want[k].astype(np.float32),
                                   rtol=tol, atol=tol)


def test_repeated_sync_hits_the_program_and_arena_caches(rng):
    grads = _grads(rng)
    with tobs.recording() as rec:
        _, eng, ar = port_sync(grads, use_kernels=True, arenas=True,
                               steps=3)
    assert rec.counter("compile.cache_miss") == 1
    assert rec.counter("compile.cache_hit") >= 3
    assert rec.counter("arena.alloc") == 1
    assert rec.counter("arena.roundtrip") == 3
    assert len(eng._sync_cache) == 1
    with LocalMesh({"data": N}, device="cpu") as mesh:
        g = tree_ranks_from_reference(grads, mesh)
        assert eng.init_arenas(g) is ar          # cached, no realloc


def test_arena_mismatch_raises(rng):
    grads = _grads(rng)
    eng = tacis.make_engine("acis", use_kernels=False)
    with LocalMesh({"data": N}, device="cpu") as mesh:
        g = tree_ranks_from_reference(grads, mesh)
        ar = eng.init_arenas(g)
        with pytest.raises(TypeError, match="bucket arenas"):
            eng.gradient_sync(g, None, arenas=ar + ar)
        bad = (torch.zeros(ar[0].shape, dtype=torch.float64),) + ar[1:]
        with pytest.raises(TypeError, match="arena 0 must be"):
            eng.gradient_sync(g, None, arenas=bad)


@pytest.mark.parametrize("backend", ["acis_hierarchical",
                                     "acis_hierarchical_compressed"])
def test_unported_backends_raise(backend):
    """The hierarchical backends, the last two to be ported, now build
    like the reference's: two-level, acis ring schedules underneath, the
    compressed one stateful."""
    eng = tacis.make_engine(backend, outer_axis="pod")
    ref = jacis.make_engine(backend, outer_axis="pod")
    assert (eng.hierarchical, eng.base_backend, eng.compressed) \
        == (ref.hierarchical, ref.base_backend, ref.compressed) \
        == (True, "acis", "compressed" in backend)
    assert tacis.BACKENDS == jacis.BACKENDS


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="not in"):
        tacis.make_engine("nccl")


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("mono", ["add", "max", "min"])
def test_compile_on_mesh_matches_reference(mesh8, rng, mono, use_kernels):
    """engine.compile(prog, mesh, P("data"), P(None)) — the README's
    quickstart spelling — on a global array."""
    x = rng.standard_normal((N * 12, 3)).astype(np.float32)
    jm, tm = jacis.TYPE1_MONOIDS[mono], tacis.TYPE1_MONOIDS[mono]
    jfn = jacis.make_engine("acis", use_kernels=use_kernels).compile(
        lambda v: jacis.reduce(jacis.map(lambda t: 2.0 * t, v), jm),
        mesh8, JP("data"), JP(None))
    tfn = tacis.make_engine("acis", use_kernels=use_kernels).compile(
        lambda v: tacis.reduce(tacis.map(lambda t: 2.0 * t, v), tm),
        LocalMesh({"data": N}, device="cpu"), P("data"), P(None))
    assert tfn.stages == jfn.stages and tfn.axes == jfn.axes
    want = np.asarray(jfn(jnp.asarray(x)))
    got = tfn(torch.from_numpy(x)).numpy()
    assert_bitwise(got, want)


def test_compile_sharded_output_round_trips(mesh8, rng):
    """P("data") out: each rank's slice comes back in rank order."""
    x = rng.standard_normal((N * 4,)).astype(np.float32)
    jfn = jacis.make_engine("acis").compile(
        lambda v: jacis.all_gather(v), mesh8, JP("data"), JP("data"))
    mesh = LocalMesh({"data": N}, device="cpu")
    tfn = tacis.make_engine("acis").compile(
        lambda v: tacis.all_gather(v), mesh, P("data"), P("data"))
    assert_bitwise(tfn(torch.from_numpy(x)).numpy(),
                   np.asarray(jfn(jnp.asarray(x))))
    t = ranks_from_reference(x, mesh)
    assert tuple(t.shape) == (N, 4)
    assert_bitwise(reference_from_ranks(t, mesh), x)


# ---------------------------------------------------------------------------
# acis_compressed: error feedback, residuals threaded over 3 steps
# ---------------------------------------------------------------------------

COMPRESSORS = ["int8", "int8_hopquant", "topk"]
TOP = 127 * 2.0 ** -5          # the planted block peak (scale 2^-5)
LEAVES32 = {k: (s, np.float32) for k, (s, _) in LEAVES.items()}


def _planted_grads(rng, leaves=LEAVES):
    """Every rank's flat leaf holds ``TOP`` at lane 0, every 50th lane and
    its last lane, and stays within ``TOP - 2^-5`` elsewhere."""
    out = {}
    for k, (s, dt) in leaves.items():
        x = np.clip(rng.standard_normal((N,) + s) * TOP / 3,
                    -(TOP - 2.0 ** -5), TOP - 2.0 ** -5).astype(np.float32)
        flat = x.reshape(N, -1)
        flat[:, ::50] = TOP
        flat[:, -1] = TOP
        out[k] = x.reshape((N * s[0],) + s[1:]).astype(dt)
    return out


def ref_compressed(mesh8, steps, *, compressor, use_kernels, state=None,
                   **kw):
    """The reference's sync over ``steps`` (a list of gradient dicts),
    the residual threaded; returns [(synced, residual)] per step as
    global numpy arrays, and the engine."""
    eng = jacis.make_engine("acis_compressed", compressor=compressor,
                            use_kernels=use_kernels, **kw)
    keys = sorted(steps[0])
    specs = tuple(JP("data", *([None] * (steps[0][k].ndim - 1)))
                  for k in keys)

    def f(rs, gs):
        synced, new = eng.gradient_sync(dict(zip(keys, gs)),
                                        dict(zip(keys, rs)))
        return tuple(synced[k] for k in keys), tuple(new[k] for k in keys)

    fn = jax.jit(jax.shard_map(f, mesh=mesh8, in_specs=(specs, specs),
                               out_specs=(specs, specs), check_vma=False))
    if state is None:
        state = {k: np.zeros(v.shape, np.float32)
                 for k, v in steps[0].items()}
    rs = tuple(jnp.asarray(state[k]) for k in keys)
    out = []
    for g in steps:
        synced, rs = fn(rs, tuple(jnp.asarray(g[k]) for k in keys))
        out.append(({k: np.asarray(v) for k, v in zip(keys, synced)},
                    {k: np.asarray(v) for k, v in zip(keys, rs)}))
    return out, eng


def port_compressed(steps, *, compressor, use_kernels, state=None,
                    arenas=False, **kw):
    eng = tacis.make_engine("acis_compressed", compressor=compressor,
                            use_kernels=use_kernels, **kw)
    mesh = LocalMesh({"data": N}, device="cpu")
    out = []
    with mesh:
        g0 = tree_ranks_from_reference(steps[0], mesh)
        st = eng.init_state(g0) if state is None \
            else tree_ranks_from_reference(state, mesh)
        ar = eng.init_arenas(g0) if arenas else None
        for g in steps:
            g = tree_ranks_from_reference(g, mesh)
            if ar is not None:
                synced, st, back = eng.gradient_sync(g, st, arenas=ar)
                assert back == tuple(ar)
            else:
                synced, st = eng.gradient_sync(g, st)
            out.append((tree_reference_from_ranks(synced, mesh),
                        tree_reference_from_ranks(st, mesh)))
    return out, eng


@pytest.mark.parametrize("arenas", [False, True])
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_compressed_sync_matches_reference_bitwise(mesh8, rng, compressor,
                                                   use_kernels, arenas):
    """f32 gradients, planted blocks: outputs and residuals bitwise over
    3 steps, and the same compiled stages."""
    steps = [_planted_grads(rng, LEAVES32) for _ in range(3)]
    want, jeng = ref_compressed(mesh8, steps, compressor=compressor,
                                use_kernels=use_kernels, topk_ratio=0.05)
    got, teng = port_compressed(steps, compressor=compressor,
                                use_kernels=use_kernels, arenas=arenas,
                                topk_ratio=0.05)
    assert teng.last_sync_program().stage_kinds() == \
        jeng.last_sync_program().stage_kinds()
    for (gs, gr), (ws, wr) in zip(got, want):
        for k in sorted(LEAVES):
            assert_bitwise(gs[k], ws[k])
            assert_bitwise(gr[k], wr[k])


def _tolerance(compressor, g, r_prev, want):
    """Random mixed-dtype gradients against the jitted reference, which
    differs through three XLA rewrites: the scale's reciprocal multiply
    and the hop's FMA (``test_torch_lookaside.py``), and excess precision
    for bf16 (:func:`test_reference_keeps_bf16_targets_in_f32`), which
    moves a bf16 target by at most ``d = 2^-9·|t|``.  The int8
    compressors then move a lane at most one quantization step
    ``s = max|t|/127``, which the EF residual takes back next step: a
    residual is within ``2s + d`` and a mean within ``2s``, plus for
    ``int8_hopquant`` the hop bound ``(n-1)·M/127/n`` (``M`` the largest
    sum of |targets| over the ranks) and one rounding of the output
    dtype."""
    t = np.abs(g.astype(np.float32)) + np.abs(r_prev)
    s = float(t.max()) / 127
    bf16 = want.dtype == ml_dtypes.bfloat16
    d = 2.0 ** -9 * t if bf16 else 0.0
    tol_out = 2 * s
    if compressor == "int8_hopquant":
        m = t.reshape((N, -1)).sum(axis=0).max()
        tol_out += (N - 1) * float(m) / 127 / N
    ulp = 2.0 ** -7 if bf16 else 2.0 ** -23
    return 2 * s + d, tol_out + ulp * np.abs(want.astype(np.float32))


@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_compressed_sync_on_random_mixed_gradients(mesh8, rng, compressor):
    """f32 and bf16 leaves, random data.  The first step has no residual
    yet and ``topk`` has no scale: there it is bitwise.  Later bf16 ``topk``
    targets differ by excess precision, which can move a lane across the
    top-k cut: at most 2% of such lanes differ beyond it."""
    steps = [_grads(rng) for _ in range(3)]
    want, _ = ref_compressed(mesh8, steps, compressor=compressor,
                             use_kernels=False)
    got, _ = port_compressed(steps, compressor=compressor,
                             use_kernels=True)
    r_prev = {k: np.zeros(v.shape, np.float32) for k, v in steps[0].items()}
    for step, (g, (gs, gr), (ws, wr)) in enumerate(zip(steps, got, want)):
        for k in sorted(LEAVES):
            bf16 = LEAVES[k][1] == ml_dtypes.bfloat16
            if compressor == "topk" and (step == 0 or not bf16):
                assert_bitwise(gs[k], ws[k])
                assert_bitwise(gr[k], wr[k])
                continue
            tol_r, tol_o = _tolerance(compressor, g[k], r_prev[k], ws[k])
            bad_r = np.abs(gr[k] - wr[k]) > tol_r
            bad_o = np.abs(gs[k].astype(np.float32)
                           - ws[k].astype(np.float32)) > tol_o
            if compressor == "topk":
                assert bad_r.mean() <= 0.02 and bad_o.mean() <= 0.02, k
            else:
                assert not bad_r.any() and not bad_o.any(), k
        r_prev = wr


def test_reference_keeps_bf16_targets_in_f32(mesh8, rng):
    """The excess-precision rewrite, shown: XLA (``xla_allow_excess_
    precision``, on by default) drops the f32→bf16→f32 round trip of the
    EF target ``t = g + r.astype(bf16)`` inside the residual's fusion, so
    the jitted reference's residual for a bf16 leaf is ``g + r -
    delivered`` with the sum never rounded to bf16 (what it quantizes
    and delivers is the rounded target).  The port rounds it, as the
    code reads.  On planted data (scale ``2^-5``, delivered ``q·2^-5``)
    each side equals its model bitwise, and the models differ."""
    steps = [_planted_grads(rng) for _ in range(2)]
    want, _ = ref_compressed(mesh8, steps, compressor="int8",
                             use_kernels=False)
    got, _ = port_compressed(steps, compressor="int8", use_kernels=False)
    bf = ml_dtypes.bfloat16
    differ = 0
    for k in ("b", "d"):                       # the bf16 leaves
        g1 = steps[1][k].astype(np.float32)
        r0 = want[0][1][k]
        assert_bitwise(got[0][1][k], r0)       # step 1 has r = 0: equal

        t_sum = (g1 + r0).astype(np.float32)
        t = (g1 + r0.astype(bf).astype(np.float32)).astype(bf) \
            .astype(np.float32)
        delivered = np.clip(np.round(t / 2.0 ** -5), -127, 127) \
            * np.float32(2.0 ** -5)
        assert_bitwise(want[1][1][k], (t_sum - delivered).astype(np.float32))
        assert_bitwise(got[1][1][k], (t - delivered).astype(np.float32))
        differ += int(np.sum(t_sum != t))
    assert differ > 0


def test_compressed_sync_carries_the_reference_residual(mesh8, rng):
    """Step 1 in JAX; its residual pytree crosses to the port through
    ``tree_ranks_from_reference`` (a residual is a pytree of rank-sharded
    arrays, like the gradients); step 2 in the port equals step 2 in
    JAX."""
    g1, g2 = (_planted_grads(rng, LEAVES32) for _ in range(2))
    want, _ = ref_compressed(mesh8, [g1, g2], compressor="int8",
                             use_kernels=False)
    got, _ = port_compressed([g2], compressor="int8", use_kernels=True,
                             state=want[0][1])
    for k in sorted(LEAVES):
        assert_bitwise(got[0][0][k], want[1][0][k])
        assert_bitwise(got[0][1][k], want[1][1][k])


def test_compressed_init_state_is_rank_stacked_f32_zeros(rng):
    eng = tacis.make_engine("acis_compressed")
    assert tacis.make_engine("acis").init_state({"a": torch.ones(2)}) is None
    with LocalMesh({"data": N}, device="cpu") as mesh:
        g = tree_ranks_from_reference(_grads(rng), mesh)
        st = eng.init_state(g)
        for k, v in g.items():
            assert st[k].shape == v.shape and st[k].dtype == torch.float32
            assert not st[k].any()
        with pytest.raises(ValueError, match="tree structure"):
            eng.gradient_sync(g, {"a": st["a"]})
