"""repro_torch hierarchical sync and core/topology.py against the JAX
reference, on a two-axis mesh.

Each case feeds one seeded numpy input to the reference, under
``jax.shard_map`` on the conftest's 8 host devices as ``mesh24`` (``pod``
2 × ``data`` 4), and to the port on ``LocalMesh({"pod": 2, "data": 4},
device="cpu")``.  A global array is split pod-major over both axes
(``P(("pod", "data"))`` in both packages), so rank ``(p, d)`` holds block
``4·p + d``.

The f32 and bf16 syncs are bitwise: the port walks the reference's
reduce-scatter over ``data``, all-reduce over ``pod`` and all-gather, one
rounding per add, and the mean divides by a power of two.  The compressed
backends are bitwise on planted-peak data (every 256-lane block peaks at
``127·2^k``, as in ``test_torch_engine.py``), where the reference's XLA
rewrites are exact.  F2 — the compressed engine's ``codec`` on the thin
outer hop of a plain ``reduce(axis="auto")`` — is held to the reference's
stages and bits.  Overlapped dispatch (one CUDA stream per mesh axis on
the card) is held bitwise to serial dispatch here on the CPU, and on the
card by the ``cuda``-marked twin.
"""

import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import core as jacis
from repro.core import topology as jtopo
from repro.core.wire import BF16 as JBF16
from repro.core.wire import resolve_codec as jresolve_codec
from repro.configs.acis_100m import CONFIG as JCONFIG
from repro.models.model import Model
from repro_torch import core as tacis
from repro_torch.configs.acis_100m import CONFIG, grad_leaf_specs
from repro_torch.core import topology as ttopo
from repro_torch.core.wire import BF16 as TBF16
from repro_torch.interop import (ranks_from_reference, reference_from_ranks,
                                 tree_ranks_from_reference,
                                 tree_reference_from_ranks)
from repro_torch.mesh import P, LocalMesh
from repro_torch.obs import metrics as tobs

N = 8
AXES = {"pod": 2, "data": 4}
LEAVES = {
    "a": ((3, 5), np.float32),
    "b": ((1, 7), ml_dtypes.bfloat16),
    "c": ((2, 4, 3), np.float32),
    "d": ((4,), ml_dtypes.bfloat16),
    "e": ((5, 11), np.float32),
    "f": ((37, 40), np.float32),
}
LEAVES32 = {k: (s, np.float32) for k, (s, _) in LEAVES.items()}
COMPRESSORS = ["int8", "int8_hopquant", "topk"]
TOP = 127 * 2.0 ** -5          # the planted block peak (scale 2^-5)


def mesh():
    return LocalMesh(AXES, device="cpu")


def smap(fn, m, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=m, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def jspec(a):
    return JP(("pod", "data"), *([None] * (a.ndim - 1)))


def assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _grads(rng, leaves=LEAVES):
    """Global arrays split pod-major over the 8 ranks: [8 * L0, ...]."""
    return {k: rng.standard_normal((N * s[0],) + s[1:]).astype(np.float32)
            .astype(dt) for k, (s, dt) in leaves.items()}


def _planted(rng, leaves=LEAVES32):
    """Every rank's flat leaf holds ``TOP`` at lane 0, every 50th lane and
    its last lane, and stays within ``TOP - 2^-5`` elsewhere, so every
    256-lane block of a bucket (and of a reduce-scatter chunk) peaks at a
    lane every rank shares."""
    out = {}
    for k, (s, dt) in leaves.items():
        x = np.clip(rng.standard_normal((N,) + s) * TOP / 3,
                    -(TOP - 2.0 ** -5), TOP - 2.0 ** -5).astype(np.float32)
        flat = x.reshape(N, -1)
        flat[:, ::50] = TOP
        flat[:, -1] = TOP
        out[k] = x.reshape((N * s[0],) + s[1:]).astype(dt)
    return out


def ref_syncs(mesh24, steps, backend, **kw):
    """The reference's sync of each gradient dict in ``steps`` on
    ``mesh24``, the residual threaded on the compressed backends; returns
    [(synced, residual or None)] as global numpy arrays, and the engine."""
    eng = jacis.make_engine(backend, inner_axis="data", outer_axis="pod",
                            **kw)
    keys = sorted(steps[0])
    specs = tuple(jspec(steps[0][k]) for k in keys)
    comp = eng.compressed

    def f(rs, gs):
        st = dict(zip(keys, rs)) if comp else None
        synced, new = eng.gradient_sync(dict(zip(keys, gs)), st)
        return (tuple(synced[k] for k in keys),
                tuple(new[k] for k in keys) if comp else ())

    rspec = specs if comp else ()
    fn = smap(f, mesh24, (rspec, specs), (specs, rspec))
    rs = tuple(jnp.zeros(steps[0][k].shape, jnp.float32)
               for k in keys) if comp else ()
    out = []
    for g in steps:
        synced, rs = fn(rs, tuple(jnp.asarray(g[k]) for k in keys))
        out.append(({k: np.asarray(v) for k, v in zip(keys, synced)},
                    {k: np.asarray(v) for k, v in zip(keys, rs)}
                    if comp else None))
    return out, eng


def port_syncs(steps, backend, *, arenas=False, **kw):
    eng = tacis.make_engine(backend, inner_axis="data", outer_axis="pod",
                            **kw)
    m = mesh()
    out = []
    with m:
        g0 = tree_ranks_from_reference(steps[0], m)
        st = eng.init_state(g0)
        ar = eng.init_arenas(g0) if arenas else None
        for g in steps:
            g = tree_ranks_from_reference(g, m)
            if ar is not None:
                synced, st, back = eng.gradient_sync(g, st, arenas=ar)
                assert back == tuple(ar)
            else:
                synced, st = eng.gradient_sync(g, st)
            out.append((tree_reference_from_ranks(synced, m),
                        tree_reference_from_ranks(st, m)
                        if st is not None else None))
    return out, eng


# ---------------------------------------------------------------------------
# the twins of tests/test_core_topology.py
# ---------------------------------------------------------------------------

def _ref_hier(mesh24, x, **kw):
    def f(xl):
        return jtopo.hierarchical_all_reduce(
            xl[0, 0], inner_axis="data", outer_axis="pod", mean=True,
            **kw)[None, None]

    spec = JP("pod", "data", None)
    return np.asarray(smap(f, mesh24, spec, spec)(
        jnp.asarray(x.reshape(2, 4, -1))))


def _port_hier(x, **kw):
    m = mesh()
    with m:
        xr = ranks_from_reference(x.reshape(2, 4, -1), m,
                                  P("pod", "data", None))
        assert tuple(xr.shape) == (2, 4, 1, 1, x.shape[-1])
        out = ttopo.hierarchical_all_reduce(
            xr[:, :, 0, 0], inner_axis="data", outer_axis="pod", mean=True,
            **kw)
    return reference_from_ranks(out[:, :, None, None], m,
                                P("pod", "data", None))


def test_hierarchical_allreduce_matches_flat(mesh24, rng):
    x = rng.standard_normal((8, 33)).astype(np.float32)
    want = _ref_hier(mesh24, x)
    got = _port_hier(x)
    assert_bitwise(got, want)
    for p in range(2):
        for d in range(4):
            np.testing.assert_allclose(got[p, d], x.mean(axis=0),
                                       rtol=1e-4, atol=1e-4)


def test_hierarchical_with_bf16_interpod_wire(mesh24, rng):
    """The bf16 codec rides the pod hop only; the reference's and the
    port's casts and bf16 adds round alike."""
    x = (rng.standard_normal((8, 64)) * 0.1).astype(np.float32)
    want = _ref_hier(mesh24, x, outer_codec=JBF16)
    got = _port_hier(x, outer_codec=TBF16)
    assert_bitwise(got, want)
    np.testing.assert_allclose(got[0, 0], x.mean(axis=0), atol=5e-3)


def _ref_masked(mesh8, x, alive):
    def f(xl, al):
        out, count = jtopo.masked_all_reduce(xl[0], al[0], "data")
        return out[None], count.reshape(1)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        out, count = smap(f, mesh8, (JP("data", None), JP("data")),
                          (JP("data", None), JP("data")))(
            jnp.asarray(x), jnp.asarray(alive))
    return np.asarray(out), np.asarray(count)


def _port_masked(x, alive):
    with LocalMesh({"data": N}, device="cpu"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            out, count = ttopo.masked_all_reduce(
                torch.from_numpy(x), torch.from_numpy(alive), "data")
    return out.numpy(), count.numpy()


def test_masked_all_reduce_drops_stragglers(mesh8, rng):
    x = rng.standard_normal((8, 10)).astype(np.float32)
    alive = np.array([1, 1, 0, 1, 1, 1, 0, 1], dtype=bool)  # 2 stragglers
    want, wcount = _ref_masked(mesh8, x, alive)
    got, count = _port_masked(x, alive)
    assert_bitwise(got, want)
    np.testing.assert_allclose(got[0], x[alive].mean(axis=0), rtol=1e-5,
                               atol=1e-5)
    assert count.shape == (N,) and (count == 6.0).all()
    assert_bitwise(count, wcount)


def test_masked_all_reduce_all_dead_is_safe(mesh8):
    x = np.ones((8, 4), np.float32)
    alive = np.zeros((8,), bool)
    want, _ = _ref_masked(mesh8, x, alive)
    got, count = _port_masked(x, alive)
    assert np.all(np.isfinite(got))           # no div-by-zero NaN
    assert_bitwise(got, want)
    assert (count == 1.0).all()


@pytest.mark.parametrize("backend", ["xla", "acis", "acis_compressed",
                                     "acis_hierarchical",
                                     "acis_hierarchical_compressed"])
def test_engine_gradient_sync_backends_agree(mesh24, rng, backend):
    """Every backend on the two-axis mesh, one step from a zero residual:
    the mean within the reference test's tolerance, and the port's sync
    against the reference's — bitwise on the ring backends, within f32
    rounding of a sum in another order on ``xla``, and within the same
    tolerance of the mean on the compressed ones (random data moves their
    lanes through XLA's rewrites, ``test_torch_engine.py``)."""
    g = {"w": rng.standard_normal((8, 24)).astype(np.float32),
         "b": rng.standard_normal((8, 7)).astype(np.float32)}
    (want,), _ = ref_syncs(mesh24, [g], backend)
    (got,), _ = port_syncs([g], backend)
    atol = 5e-2 if "compressed" in backend else 1e-4
    for k in g:
        np.testing.assert_allclose(got[0][k].reshape(8, -1)[0],
                                   g[k].mean(0), atol=atol)
        if backend == "xla":
            np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-6,
                                       atol=1e-6)
        elif "compressed" not in backend:
            assert_bitwise(got[0][k], want[0][k])
        else:
            np.testing.assert_allclose(got[0][k], want[0][k], atol=atol)


def test_engine_rejects_unknown_backend():
    with pytest.raises(ValueError):
        tacis.make_engine("nccl")


def test_compile_cache_is_bounded_lru():
    """The cache evicts least-recently-used past the knob and counts the
    evictions, as the reference's does."""
    prev = ttopo.set_compile_cache_size(2)
    saved = dict(ttopo._COMPILE_CACHE)
    ttopo._COMPILE_CACHE.clear()
    try:
        with tobs.recording() as rec:
            ttopo._cache_put(("k", 1), "a")
            ttopo._cache_put(("k", 2), "b")
            assert ttopo._cache_get(("k", 1)) == "a"     # 1 becomes MRU
            ttopo._cache_put(("k", 3), "c")              # evicts 2, not 1
            assert ttopo._cache_get(("k", 2)) is None
            assert ttopo._cache_get(("k", 1)) == "a"
            assert len(ttopo._COMPILE_CACHE) == 2
        assert rec.counter("topology.compile_cache_evicted") == 1

        with tobs.recording() as rec:
            assert ttopo.set_compile_cache_size(1) == 2   # returns prev
        assert len(ttopo._COMPILE_CACHE) == 1             # shrink evicts
        assert rec.counter("topology.compile_cache_evicted") == 1
    finally:
        ttopo.set_compile_cache_size(prev)
        ttopo._COMPILE_CACHE.clear()
        ttopo._COMPILE_CACHE.update(saved)
    assert ttopo.compile_cache_size() == jtopo.compile_cache_size()


def test_compile_cache_hits_and_evicts_through_the_wrapper(rng):
    """The wrapper caches per local shape: a second call of the same
    shape compiles nothing, a third shape past a capacity of 2 evicts."""
    prev = ttopo.set_compile_cache_size(2)
    saved = dict(ttopo._COMPILE_CACHE)
    ttopo._COMPILE_CACHE.clear()
    try:
        with mesh(), tobs.recording() as rec:
            for n in (5, 5, 6, 7):
                ttopo.hierarchical_all_reduce(torch.ones((2, 4, n)))
        assert rec.counter("compile.programs") == 3
        assert rec.counter("topology.compile_cache_evicted") == 1
    finally:
        ttopo.set_compile_cache_size(prev)
        ttopo._COMPILE_CACHE.clear()
        ttopo._COMPILE_CACHE.update(saved)


def test_masked_all_reduce_is_deprecated():
    with LocalMesh({"data": N}, device="cpu"):
        with pytest.warns(DeprecationWarning, match="masked_reduce"):
            ttopo.masked_all_reduce(torch.ones((N, 4)),
                                    torch.ones(N, dtype=torch.bool), "data")


def test_pod_aware_axes(mesh24, mesh8):
    assert ttopo.pod_aware_axes(mesh()) == jtopo.pod_aware_axes(mesh24) \
        == ("data", "pod")
    assert ttopo.pod_aware_axes(LocalMesh({"data": N}, device="cpu")) \
        == jtopo.pod_aware_axes(mesh8) == ("data", None)


# ---------------------------------------------------------------------------
# the engine's Type 1 methods and multi-axis partition specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "acis_hierarchical"])
@pytest.mark.parametrize("axis", ["data", "pod"])
def test_engine_type1_methods_match_reference(mesh24, rng, backend, axis):
    """all_reduce / all_gather / reduce_scatter / all_to_all over one axis
    of the two-axis mesh, on the engine's base backend."""
    x = rng.standard_normal((N * 8, 3)).astype(np.float32)
    spec = JP(("pod", "data"), None)
    jeng = jacis.make_engine(backend, outer_axis="pod")
    teng = tacis.make_engine(backend, outer_axis="pod")

    def ref(xl):
        return (jeng.all_reduce(xl, axis), jeng.all_gather(xl, axis),
                jeng.reduce_scatter(xl, axis), jeng.all_to_all(xl, axis))

    want = smap(ref, mesh24, spec, (spec,) * 4)(jnp.asarray(x))
    m = mesh()
    with m:
        xr = ranks_from_reference(x, m)
        got = (teng.all_reduce(xr, axis), teng.all_gather(xr, axis),
               teng.reduce_scatter(xr, axis), teng.all_to_all(xr, axis))
    for g, w in zip(got, want):
        g = reference_from_ranks(g, m)
        if backend == "xla":
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
        else:
            assert_bitwise(g, w)


@pytest.mark.parametrize("spec", ["per_dim", "compound"])
def test_compile_on_a_two_axis_mesh_matches_reference(mesh24, rng, spec):
    """engine.compile(prog, mesh, in_specs, out_specs) with the reference's
    multi-axis spellings: one mesh axis per dim, and a compound leading
    dim split pod-major."""
    if spec == "per_dim":
        x = rng.standard_normal((2, 4, 12)).astype(np.float32)
        jsp, tsp = JP("pod", "data", None), P("pod", "data", None)
        local = (1, 1, 12)
    else:
        x = rng.standard_normal((N * 12,)).astype(np.float32)
        jsp, tsp = JP(("pod", "data")), P(("pod", "data"))
        local = (12,)

    def prog(a):
        return lambda v: a.reduce(v, axis="auto")

    jfn = jacis.make_engine("acis_hierarchical", outer_axis="pod").compile(
        prog(jacis), mesh24, jsp, jsp,
        in_avals=(jax.ShapeDtypeStruct(local, jnp.float32),))
    tfn = tacis.make_engine("acis_hierarchical", outer_axis="pod").compile(
        prog(tacis), mesh(), tsp, tsp,
        in_avals=(tacis.TensorSpec(local, torch.float32),))
    assert tfn.stages == jfn.stages and tfn.axes == jfn.axes
    assert tfn.schedules == jfn.schedules
    assert_bitwise(tfn(torch.from_numpy(x)).numpy(),
                   np.asarray(jfn(jnp.asarray(x))))


def test_two_axis_specs_round_trip(rng):
    """shard/unshard: every spelling the reference accepts, inverse of
    each other, and the axes a spec leaves out holding copies."""
    m = mesh()
    x = torch.from_numpy(rng.standard_normal((8, 4, 6)).astype(np.float32))
    for spec, local in ((P("pod", "data"), (4, 1, 6)),
                        (P(("pod", "data")), (1, 4, 6)),
                        (P(("data", "pod")), (1, 4, 6)),
                        (P(None, "data"), (8, 1, 6)),
                        (P("data", None, "pod"), (2, 4, 3)),
                        (P(), (8, 4, 6))):
        y = m.shard(x, spec)
        assert tuple(y.shape) == (2, 4) + local, spec
        assert torch.equal(m.unshard(y, spec), x), spec
    y = m.shard(x, P(("pod", "data")))
    assert torch.equal(y[1, 2, 0], x[4 + 2])            # pod-major
    y = m.shard(x, P("data"))
    assert torch.equal(y[0], y[1])                      # copies over pod
    with pytest.raises(ValueError, match="used twice"):
        m.shard(x, P("data", "data"))
    with pytest.raises(KeyError):
        m.shard(x, P("model"))


# ---------------------------------------------------------------------------
# the hierarchical sync: structure as data, then bits
# ---------------------------------------------------------------------------

def structure(cp) -> dict:
    return {
        "kinds": cp.stage_kinds(),
        "schedules": cp.stage_schedules(),
        "axes": cp.stage_axes(),
        "bytes_in": [st.ir.bytes_in for st in cp.stages],
        "in_vids": [st.in_vids for st in cp.stages],
        "out_vids": [st.out_vids for st in cp.stages],
        "deps": cp.plan.deps,
        "waves": cp.plan.waves,
        "wave_groups": cp.plan.wave_groups,
        "arenas": [(tuple(a.shape), str(jnp.dtype(a.dtype)))
                   for a in cp.arena_avals],
        "arena_slots": [st.arena_slot for st in cp.stages],
        "transient": (cp.pack_transient_bytes(),
                      cp.pack_transient_bytes(arenas=True)),
    }


@pytest.mark.parametrize("backend,compressor", [
    ("acis_hierarchical", "int8")] + [
    ("acis_hierarchical_compressed", c) for c in COMPRESSORS])
def test_full_width_hierarchical_structure_matches_reference(backend,
                                                             compressor):
    """The acis-100m gradient sync at full width (avals only) on pod 2 ×
    data 4: the same stages, axes, schedules, payloads, waves, dispatch
    groups and bucket arenas as the reference."""
    shapes = Model(JCONFIG).param_shapes()
    jeng = jacis.make_engine(backend, compressor=compressor,
                             inner_axis="data", outer_axis="pod",
                             use_kernels=True)
    jeng.init_arenas(shapes, axis_sizes=AXES)
    teng = tacis.make_engine(backend, compressor=compressor,
                             inner_axis="data", outer_axis="pod",
                             use_kernels=True)
    m = LocalMesh(AXES, device="meta")
    grads = {k: torch.empty((2, 4) + s, dtype=dt, device="meta")
             for k, s, dt in grad_leaf_specs(CONFIG)}
    teng.init_arenas(grads, mesh=m)
    tcp, jcp = teng.last_sync_program(), jeng.last_sync_program()
    t, j = structure(tcp), structure(jcp)
    for k in j:
        assert t[k] == j[k], f"{k}: port {t[k]} != reference {j[k]}"
    assert set(tcp.axes()) == {"data", "pod"}
    if backend == "acis_hierarchical":
        # the pipelined buckets put a data ring beside a pod ring
        assert any(sum(1 for ax, _ in g if ax) > 1
                   for g in tcp.plan.wave_groups)


@pytest.mark.parametrize("bucket_bytes", [None, 256])
@pytest.mark.parametrize("arenas", [False, True])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_hierarchical_sync_matches_reference_bitwise(mesh24, rng,
                                                     use_kernels, arenas,
                                                     bucket_bytes):
    grads = _grads(rng)
    (want,), jeng = ref_syncs(mesh24, [grads], "acis_hierarchical",
                              use_kernels=use_kernels,
                              bucket_bytes=bucket_bytes)
    (got,), teng = port_syncs([grads], "acis_hierarchical",
                              use_kernels=use_kernels, arenas=arenas,
                              bucket_bytes=bucket_bytes)
    assert teng.last_sync_program().stage_kinds() == \
        jeng.last_sync_program().stage_kinds()
    for k in sorted(grads):
        assert_bitwise(got[0][k], want[0][k])


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("compressor", COMPRESSORS)
def test_hierarchical_compressed_sync_bitwise_on_planted_peaks(
        mesh24, rng, compressor, use_kernels):
    """acis_hierarchical_compressed, 3 steps with the residual threaded:
    outputs and residuals bitwise on planted f32 gradients."""
    steps = [_planted(rng) for _ in range(3)]
    want, jeng = ref_syncs(mesh24, steps, "acis_hierarchical_compressed",
                           compressor=compressor, topk_ratio=0.05,
                           use_kernels=use_kernels)
    got, teng = port_syncs(steps, "acis_hierarchical_compressed",
                           compressor=compressor, topk_ratio=0.05,
                           use_kernels=use_kernels, arenas=True)
    assert teng.last_sync_program().stage_kinds() == \
        jeng.last_sync_program().stage_kinds()
    for (gs, gr), (ws, wr) in zip(got, want):
        for k in sorted(LEAVES):
            assert_bitwise(gs[k], ws[k])
            assert_bitwise(gr[k], wr[k])


# ---------------------------------------------------------------------------
# F2: the compressed engine's codec on the thin outer hop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True])
def test_compressed_engine_puts_its_codec_on_the_outer_hop(mesh24, rng,
                                                           use_kernels):
    """``engine.compile`` of a plain ``reduce(axis="auto")`` on
    acis_hierarchical_compressed: LowerTopology reads the config's
    ``codec`` (default ``"int8"``) for the pod hop.  The port's stages,
    axes, schedules and codecs equal the reference's, with
    ``int8_b256`` on the pod all-reduce, and the output is bitwise the
    reference's on planted-peak data.  (Before the config carried
    ``codec`` the port's compressed hierarchical engine could not be
    built at all, so this shows the repair, not a failure of the
    parent.)"""
    x = _planted(rng, {"x": ((4096,), np.float32)})["x"]
    local = (4096,)

    def prog(a):
        return lambda v: a.reduce(v, axis="auto")

    spec_j, spec_t = JP(("pod", "data")), P(("pod", "data"))
    jeng = jacis.make_engine("acis_hierarchical_compressed",
                             inner_axis="data", outer_axis="pod",
                             use_kernels=use_kernels)
    teng = tacis.make_engine("acis_hierarchical_compressed",
                             inner_axis="data", outer_axis="pod",
                             use_kernels=use_kernels)
    assert teng.config.codec == jeng.config.codec == "int8"
    assert "int8" in teng.config.cache_key()
    jfn = jeng.compile(prog(jacis), mesh24, spec_j, spec_j,
                       in_avals=(jax.ShapeDtypeStruct(local, jnp.float32),))
    tfn = teng.compile(prog(tacis), mesh(), spec_t, spec_t,
                       in_avals=(tacis.TensorSpec(local, torch.float32),))

    def codecs(cp):
        out = []
        for st in cp.stages:
            names = [nd.op.codec.name for nd in st.ir.nodes
                     if nd.op.codec.name != "identity"]
            out.append(names[0] if names else "-")
        return out

    tcp, jcp = tfn.compiled, jfn.compiled
    assert tcp.stage_kinds() == jcp.stage_kinds() == [
        "map", "reduce_scatter", "allreduce", "allgather", "map"]
    assert tcp.stage_axes() == jcp.stage_axes()
    assert tcp.stage_schedules() == jcp.stage_schedules()
    assert codecs(tcp) == codecs(jcp) == ["-", "-", "int8_b256", "-", "-"]
    got = tfn(torch.from_numpy(x)).numpy()
    want = np.asarray(jfn(jnp.asarray(x)))
    assert_bitwise(got, want)
    exact = x.reshape(N, -1).astype(np.float64).sum(0)
    np.testing.assert_allclose(got.reshape(N, -1)[0], exact,
                               atol=4 * TOP / 127 * 2)


def test_codec_config_is_resolved_like_the_reference():
    for name in ("int8", "bf16", "fp8"):
        eng = tacis.make_engine("acis_hierarchical_compressed",
                                outer_axis="pod", codec=name)
        cp = eng.compile(lambda v: tacis.reduce(v, axis="auto"),
                         in_avals=(tacis.TensorSpec((64,), torch.float32),),
                         axis_size=AXES)
        (outer,) = [st for st in cp.stages if st.axis == "pod"]
        want = jresolve_codec(name).name
        assert outer.ir.nodes[0].op.codec.name == want
    flat = tacis.make_engine("acis_hierarchical", outer_axis="pod")
    cp = flat.compile(lambda v: tacis.reduce(v, axis="auto"),
                      in_avals=(tacis.TensorSpec((64,), torch.float32),),
                      axis_size=AXES)
    assert all(nd.op.codec.name == "identity" for st in cp.stages
               for nd in st.ir.nodes)


# ---------------------------------------------------------------------------
# overlapped and serial dispatch
# ---------------------------------------------------------------------------

def _overlap_pair(rng, device, **kw):
    grads = _grads(rng, LEAVES32)
    outs = []
    for overlap in (True, False):
        eng = tacis.make_engine("acis_hierarchical", outer_axis="pod",
                                overlap_dispatch=overlap, bucket_bytes=256,
                                **kw)
        m = LocalMesh(AXES, device=device)
        with m:
            g = tree_ranks_from_reference(grads, m)
            synced, _ = eng.gradient_sync(g, None)
            cp = eng.last_sync_program()
        outs.append(({k: v.cpu() for k, v in synced.items()}, cp))
    return outs


def test_overlapped_and_serial_dispatch_agree_bitwise(rng):
    """Overlapped dispatch (round-robin across a wave's axis groups) and
    serial dispatch (plan order) give the same bits; the plan has waves
    that hold a ring on each axis, which the card runs on two streams."""
    (ov, cp_ov), (se, cp_se) = _overlap_pair(rng, "cpu")
    assert cp_ov.overlap and not cp_se.overlap
    assert cp_ov.plan.waves == cp_se.plan.waves
    assert any(sum(1 for ax, _ in g if ax) > 1
               for g in cp_ov.plan.wave_groups)
    for k in ov:
        assert torch.equal(ov[k].view(torch.int32), se[k].view(torch.int32))
    assert not cp_ov.plan.streams            # the CPU makes no streams


@pytest.mark.cuda
def test_overlapped_dispatch_on_per_axis_streams_cuda(rng):
    """On the card: the multi-axis waves run on one stream per mesh axis,
    bitwise equal to serial dispatch with kernels on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA streams exist only there")
    for uk in (True, False):
        (ov, cp_ov), (se, _) = _overlap_pair(rng, "cuda", use_kernels=uk)
        assert sorted(ax for _, ax in cp_ov.plan.streams) == \
            ["data", "pod"]
        for k in ov:
            assert torch.equal(ov[k].view(torch.int32),
                               se[k].view(torch.int32))
