"""repro_torch CollectiveEngine end to end against the JAX reference.

``gradient_sync`` on a small mixed f32/bf16 gradient pytree: one seeded
numpy input, the reference under ``jax.shard_map`` on 8 host devices
(Pallas kernels in interpret mode when ``use_kernels=True``), the port on
``LocalMesh({"data": 8}, device="cpu")``.  f32 leaves must match
bitwise; bf16 leaves too, since every ring add rounds once in both
frameworks and the mean divides by a power of two.  ``use_kernels`` is set
explicitly on both sides.
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
                                 tree_ranks_from_reference)
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


def _grads(rng):
    """Global arrays the reference shards P("data"): [N * L0, ...]."""
    return {k: rng.standard_normal((N * s[0],) + s[1:]).astype(np.float32)
            .astype(dt) for k, (s, dt) in LEAVES.items()}


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


@pytest.mark.parametrize("backend", ["acis_compressed", "acis_hierarchical",
                                     "acis_hierarchical_compressed"])
def test_unported_backends_raise(backend):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tacis.make_engine(backend)


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
