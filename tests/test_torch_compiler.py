"""repro_torch compiler structure against the JAX reference, compared as data.

The port runs the reference's passes rule for rule (minus PlaceCGRA), so a
program must compile to the same stages, schedules, axes, per-stage
payload bytes, dependency edges, waves, dispatch groups, arena avals and
pack transient — at the full width of acis-100m (avals only, no data) and
on small programs that exercise bucketing, batched rings and RS/AG
buckets.  Where a small program is cheap to run, the outputs are held
bitwise too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import core as jacis
from repro.configs.acis_100m import CONFIG as JCONFIG
from repro.models.model import Model
from repro_torch import core as tacis
from repro_torch.configs.acis_100m import CONFIG, SMOKE, grad_leaf_specs
from repro_torch.mesh import P, LocalMesh

N = 8
TDT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def structure(cp) -> dict:
    """Everything about a compiled program that must match, as data."""
    return {
        "kinds": cp.stage_kinds(),
        "schedules": cp.stage_schedules(),
        "axes": cp.stage_axes(),
        "bytes_in": [st.ir.bytes_in for st in cp.stages],
        "in_vids": [st.in_vids for st in cp.stages],
        "out_vids": [st.out_vids for st in cp.stages],
        # the ring-schedule decisions; the reference appends its CGRA
        # placement (" | ...") and describes map stages by it, which is
        # not ported yet
        "descs": [st.desc.split(" | ")[0] for st in cp.stages
                  if st.kind in ("allreduce", "batched_allreduce",
                                 "map+allreduce")],
        "deps": cp.plan.deps,
        "waves": cp.plan.waves,
        "wave_groups": cp.plan.wave_groups,
        "arenas": [(tuple(a.shape), str(jnp.dtype(a.dtype)))
                   for a in cp.arena_avals],
        "arena_slots": [st.arena_slot for st in cp.stages],
        "transient": (cp.pack_transient_bytes(),
                      cp.pack_transient_bytes(arenas=True)),
        "n_in": cp.source.num_inputs,
        "outputs": cp.source.outputs,
    }


def assert_same_structure(tcp, jcp):
    t, j = structure(tcp), structure(jcp)
    for k in j:
        assert t[k] == j[k], f"{k}: port {t[k]} != reference {j[k]}"


# ---------------------------------------------------------------------------
# acis-100m at full width
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full_width():
    shapes = Model(JCONFIG).param_shapes()
    jeng = jacis.make_engine("acis", use_kernels=True)
    jar = jeng.init_arenas(shapes, axis_sizes={"data": N})
    teng = tacis.make_engine("acis", use_kernels=True)
    mesh = LocalMesh({"data": N}, device="meta")
    grads = {k: torch.empty((N,) + s, dtype=dt, device="meta")
             for k, s, dt in grad_leaf_specs(CONFIG)}
    tar = teng.init_arenas(grads, mesh=mesh)
    return shapes, jeng.last_sync_program(), jar, \
        teng.last_sync_program(), tar


def test_grad_leaf_specs_match_the_reference_model():
    leaves = jax.tree_util.tree_leaves_with_path(
        Model(JCONFIG).param_shapes())
    specs = grad_leaf_specs(CONFIG)
    assert len(specs) == len(leaves) == 12
    for (name, shape, dt), (path, leaf) in zip(specs, leaves):
        keys = ".".join(str(getattr(p, "key", p)) for p in path)
        assert name == keys
        assert shape == tuple(leaf.shape)
        assert dt == TDT[leaf.dtype.type if hasattr(leaf.dtype, "type")
                         else leaf.dtype]
    n_params = sum(int(np.prod(s)) for _, s, _ in specs)
    assert n_params == 124_668_672


def test_grad_leaf_specs_smoke_config_matches_reference():
    from repro.configs.acis_100m import SMOKE as JSMOKE

    leaves = jax.tree_util.tree_leaves(Model(JSMOKE).param_shapes())
    assert [s for _, s, _ in grad_leaf_specs(SMOKE)] == \
        [tuple(l.shape) for l in leaves]


def test_full_width_sync_structure_matches_reference(full_width):
    _, jcp, jar, tcp, tar = full_width
    assert_same_structure(tcp, jcp)
    assert len(tcp.stages) == 24
    assert tcp.stage_kinds().count("allreduce") == 10
    assert tcp.plan.n_waves == 12


def test_full_width_arena_is_one_f32_bucket(full_width):
    _, jcp, jar, tcp, tar = full_width
    assert [(tuple(a.shape), str(a.dtype)) for a in jar] == \
        [((19200,), "float32")]
    assert [(tuple(a.shape), a.dtype) for a in tar] == \
        [((N, 19200), torch.float32)]
    assert tcp.pack_transient_bytes() == 153_600
    assert tcp.pack_transient_bytes(arenas=True) == 76_800


def test_full_width_hop_and_pack_counts(full_width):
    """What chip_smoke.py checks its launch counts against: 7 hops on
    each of the 10 rings, one arena pack."""
    _, _, _, tcp, _ = full_width
    hops = sum(N - 1 for st in tcp.stages if st.kind == "allreduce")
    packs = sum(st.arena_slot is not None for st in tcp.stages)
    assert (hops, packs) == (70, 1)


@pytest.mark.parametrize("compressor", ["int8", "int8_hopquant", "topk"])
def test_full_width_compressed_sync_structure_matches_reference(compressor):
    """acis_compressed at full width: the same stages, buckets and arenas
    as the reference.  Coalesce buckets the blockwise compressors' three
    f32 norm-scale leaves into one EF bucket (one arena pack) and leaves
    top-k unbucketed; what ``chip_smoke.py`` checks its launch counts
    against: one quant_hop per hop of every int8_hopquant stage, and
    per top-k stage one accumulate of the rank's own payload, one per hop
    and one for the decompress."""
    shapes = Model(JCONFIG).param_shapes()
    jeng = jacis.make_engine("acis_compressed", compressor=compressor,
                             use_kernels=True)
    jar = jeng.init_arenas(shapes, axis_sizes={"data": N})
    teng = tacis.make_engine("acis_compressed", compressor=compressor,
                             use_kernels=True)
    mesh = LocalMesh({"data": N}, device="meta")
    grads = {k: torch.empty((N,) + s, dtype=dt, device="meta")
             for k, s, dt in grad_leaf_specs(CONFIG)}
    tar = teng.init_arenas(grads, mesh=mesh)
    tcp, jcp = teng.last_sync_program(), jeng.last_sync_program()
    assert_same_structure(tcp, jcp)
    ef = [st for st in tcp.stages if st.kind == "ef_allreduce"]
    assert all(len(st.out_vids) == 2 for st in ef)
    if compressor == "topk":
        assert len(ef) == 12 and tar is None and jar is None
        assert (N + 1) * len(ef) == 108
    else:
        assert len(ef) == 10
        assert [tuple(a.shape) for a in tar] == [(N, 19200)]
        assert (N - 1) * len(ef) == 70


# ---------------------------------------------------------------------------
# small programs
# ---------------------------------------------------------------------------

def _sync_fn(acis, n_leaves, mean):
    def sync(*gs):
        return tuple(acis.map(mean, acis.reduce(g, axis="auto"),
                              name="mean", elementwise=True) for g in gs)
    return acis.trace(sync, num_inputs=n_leaves, name="sync")


def _compile_pair(make_prog, avals, **cfg):
    """Compile one program (built per package by ``make_prog(acis)``)
    rank-local in both packages from the same local avals."""
    jcp = jacis.make_engine("acis", **cfg).compile(
        make_prog(jacis), in_avals=[jax.ShapeDtypeStruct(s, jnp.float32)
                                    for s in avals], axis_size=N)
    tcp = tacis.make_engine("acis", **cfg).compile(
        make_prog(tacis), in_avals=[tacis.TensorSpec(s, torch.float32)
                                    for s in avals], axis_size=N)
    return tcp, jcp


RAGGED64 = [(1 + (7 * i) % 53, 1 + (3 * i) % 5) for i in range(64)]


@pytest.mark.parametrize("epilogue_hoist", [True, False])
def test_64_leaf_ragged_bucketed_sync(epilogue_hoist):
    def mean(y):
        return y / 8
    tcp, jcp = _compile_pair(lambda a: _sync_fn(a, 64, mean), RAGGED64,
                             bucket_bytes=8192,
                             epilogue_hoist=epilogue_hoist)
    assert_same_structure(tcp, jcp)
    assert len(tcp.arena_avals) > 1


def test_batched_rings_structure_and_numerics(mesh8, rng):
    sizes = [(5,), (16,), (3, 7), (40,)]

    def prog(acis):
        def f(*xs):
            return tuple(acis.reduce(x, axis="data") for x in xs)
        return acis.trace(f, num_inputs=len(sizes))

    tcp, jcp = _compile_pair(prog, sizes, bucket_bytes=0, batch_rings=True)
    assert_same_structure(tcp, jcp)
    assert "batched_allreduce" in tcp.stage_kinds()
    xs = [rng.standard_normal((N,) + s).astype(np.float32) for s in sizes]
    _assert_runs_equal(tcp, jcp, mesh8, xs)


def test_rs_ag_buckets_structure_and_numerics(mesh8, rng):
    rs = [(16,), (8, 3), (24,)]
    ag = [(2,), (5, 2), (3,)]

    def prog(acis):
        def f(*xs):
            return tuple(acis.reduce_scatter(x, axis="data")
                         for x in xs[:3]) + tuple(
                acis.all_gather(x, axis="data") for x in xs[3:])
        return acis.trace(f, num_inputs=6)

    tcp, jcp = _compile_pair(prog, rs + ag)
    assert_same_structure(tcp, jcp)
    assert tcp.stage_kinds().count("reduce_scatter") == 1
    assert tcp.stage_kinds().count("allgather") == 1
    xs = [rng.standard_normal((N,) + s).astype(np.float32)
          for s in rs + ag]
    _assert_runs_equal(tcp, jcp, mesh8, xs)


def _assert_runs_equal(tcp, jcp, mesh8, xs):
    """Run the rank-local programs: the reference under shard_map (each
    rank holds x[r]), the port inside the mesh on the stacked xs."""
    specs = tuple(JP("data", *([None] * (x.ndim - 1))) for x in xs)

    def f(*ls):
        return tuple(o[None] for o in jcp(*[l[0] for l in ls]))

    n_out = len(jcp.source.outputs)
    want = jax.jit(jax.shard_map(
        f, mesh=mesh8, in_specs=specs,
        out_specs=tuple(JP("data") for _ in range(n_out)),
        check_vma=False))(*map(jnp.asarray, xs))
    with LocalMesh({"data": N}, device="cpu"):
        got = tcp(*map(torch.from_numpy, xs))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      w.view(np.uint32))


# ---------------------------------------------------------------------------
# the Type 4 fused stages: same stages, same outputs as the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True])
def test_fused_scan_and_alltoall_stages_run_like_the_reference(
        mesh8, rng, use_kernels):
    """Fig. 5 (AG∘scan∘AG → ``scan+allgather``) beside NAS IS (reduce +
    all-to-all → ``allreduce+alltoall``) in one program.  The scan input
    is integer-valued, so every partial sum is exact and the port's
    in-order local scan equals the reference's associative one bit for
    bit; ``use_kernels`` runs the prefix_sum kernel's plain version here
    (CPU tensors)."""
    def prog(acis):
        def f(x, h, k):
            a = acis.all_gather(acis.scan(acis.all_gather(x)))
            return a, acis.reduce(h), acis.all_to_all(k)
        return acis.trace(f)

    tcp, jcp = _compile_pair(prog, [(4,), (16,), (16,)],
                             use_kernels=use_kernels)
    assert_same_structure(tcp, jcp)
    assert set(tcp.stage_kinds()) == {"scan+allgather",
                                      "allreduce+alltoall"}
    xs = [rng.integers(-9, 10, (N, 4)).astype(np.float32),
          rng.integers(0, 50, (N, 16)).astype(np.float32),
          rng.standard_normal((N, 16)).astype(np.float32)]
    _assert_runs_equal(tcp, jcp, mesh8, xs)
    with LocalMesh({"data": N}, device="cpu"):
        a, h, k = tcp(*map(torch.from_numpy, xs))
    np.testing.assert_array_equal(a.numpy()[3], np.cumsum(xs[0]))
    np.testing.assert_array_equal(h.numpy()[5], xs[1].sum(0))
    np.testing.assert_array_equal(
        k.numpy(), xs[2].reshape(N, N, 2).transpose(1, 0, 2).reshape(N, 16))


@pytest.mark.parametrize("monoid,exclusive", [("max", False),
                                              ("add", True)])
def test_generic_scan_allgather_stage_runs_like_the_reference(
        mesh8, rng, monoid, exclusive):
    """A scan that is not an inclusive add lowers to the generic rank scan
    + gather (no prefix_sum kernel): bitwise on random data."""
    def prog(acis):
        def f(x):
            m = getattr(acis, monoid.upper())
            return acis.all_gather(acis.scan(acis.all_gather(x), m,
                                             exclusive=exclusive))
        return acis.trace(f)

    tcp, jcp = _compile_pair(prog, [(6,)], use_kernels=True)
    assert_same_structure(tcp, jcp)
    assert tcp.stage_kinds() == ["scan+allgather"]
    _assert_runs_equal(tcp, jcp, mesh8,
                       [rng.standard_normal((N, 6)).astype(np.float32)])


def test_map_reduce_scatter_stage_runs_like_the_reference(mesh8, rng):
    def prog(acis):
        def f(x):
            sq = jnp.square if acis is jacis else torch.square
            return acis.reduce_scatter(acis.map(sq, x, name="square"))
        return acis.trace(f)

    tcp, jcp = _compile_pair(prog, [(32,)])
    assert_same_structure(tcp, jcp)
    assert tcp.stage_kinds() == ["map+reduce_scatter"]
    x = rng.standard_normal((N, 32)).astype(np.float32)
    _assert_runs_equal(tcp, jcp, mesh8, [x])
    with LocalMesh({"data": N}, device="cpu"):
        (got,) = tcp(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy().reshape(-1),
                               np.square(x).sum(0), rtol=1e-5, atol=1e-5)


def test_allgather_map_stage_runs_like_the_reference(mesh8, rng):
    def prog(acis):
        def f(x):
            # one rounding per lane (an affine map would meet XLA's FMA
            # contraction, ROADMAP.md §3)
            return acis.map(lambda c: c * 3.0, acis.all_gather(x),
                            name="triple")
        return acis.trace(f)

    tcp, jcp = _compile_pair(prog, [(5,)])
    assert_same_structure(tcp, jcp)
    assert tcp.stage_kinds() == ["allgather+map"]
    x = rng.standard_normal((N, 5)).astype(np.float32)
    _assert_runs_equal(tcp, jcp, mesh8, [x])
    with LocalMesh({"data": N}, device="cpu"):
        (got,) = tcp(torch.from_numpy(x))
    for r in range(N):
        np.testing.assert_array_equal(got.numpy()[r],
                                      (x * 3.0).reshape(-1))


def test_fig5_program_through_engine_compile_on_a_mesh(mesh8, rng):
    """The README spelling of the Fig. 5 program: P("data") in, P(None)
    out — the global prefix sum on every rank."""
    x = rng.integers(-9, 10, (N * 12,)).astype(np.float32)

    def prog(acis):
        return lambda v: acis.all_gather(acis.scan(acis.all_gather(v)))

    jfn = jacis.make_engine("acis").compile(prog(jacis), mesh8, JP("data"),
                                            JP(None))
    tfn = tacis.make_engine("acis").compile(
        prog(tacis), LocalMesh({"data": N}, device="cpu"), P("data"),
        P(None))
    assert tfn.stages == jfn.stages == ["scan+allgather"]
    got = tfn(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(jfn(jnp.asarray(x)))
                                  .view(np.uint32))
    np.testing.assert_array_equal(got.numpy(), np.cumsum(x))


def test_cost_model_views_wait_for_the_mapper():
    tcp, jcp = _compile_pair(lambda a: _sync_fn(a, 3, lambda y: y / 8),
                             [(4,), (9,), (2, 2)])
    with pytest.raises(NotImplementedError, match="mapper"):
        tcp.program_time()
    with pytest.raises(NotImplementedError, match="mapper"):
        tcp.explain(trace=[])
    # the table itself matches, placement column aside
    t_rows = [ln.split()[:5] for ln in tcp.explain().splitlines()[1:-1]]
    j_rows = [ln.split()[:5] for ln in jcp.explain().splitlines()[1:-1]]
    assert t_rows == j_rows


def test_compile_on_a_mesh_splits_and_replicates(mesh8, rng):
    """The README spelling, on a multi-input program: P("data") in,
    P(None) out."""
    x = rng.standard_normal((N * 6,)).astype(np.float32)
    y = rng.standard_normal((N * 2, 3)).astype(np.float32)

    def prog(acis):
        def f(a, b):
            return acis.reduce(a), acis.reduce(b, acis.MAX)
        return f

    jfn = jacis.make_engine("acis").compile(
        prog(jacis), mesh8, (JP("data"), JP("data")), (JP(None), JP(None)))
    tfn = tacis.make_engine("acis").compile(
        prog(tacis), LocalMesh({"data": N}, device="cpu"),
        (P("data"), P("data")), (P(None), P(None)))
    for g, w in zip(tfn(torch.from_numpy(x), torch.from_numpy(y)),
                    jfn(jnp.asarray(x), jnp.asarray(y))):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))


def test_masked_reduce_buckets_and_runs_like_the_reference(mesh8, rng):
    """masked_reduce: Legalize's masked_pack → REDUCE, bucketed by
    Coalesce with one shared count lane; dead ranks contribute nothing
    and the mean renormalizes by the live count."""
    sizes = [(6,), (3, 4), (10,)]

    def prog(acis):
        def f(a, b, c, alive):
            outs = [acis.masked_reduce(x, alive)[0] for x in (a, b, c)]
            return tuple(outs)
        return acis.trace(f)

    jcp = jacis.make_engine("acis").compile(
        prog(jacis), in_avals=[jax.ShapeDtypeStruct(s, jnp.float32)
                               for s in sizes]
        + [jax.ShapeDtypeStruct((), jnp.float32)], axis_size=N)
    tcp = tacis.make_engine("acis").compile(
        prog(tacis), in_avals=[tacis.TensorSpec(s, torch.float32)
                               for s in sizes]
        + [tacis.TensorSpec((), torch.float32)], axis_size=N)
    assert_same_structure(tcp, jcp)
    assert "masked_pack" not in tcp.explain()      # bucketed, not per leaf
    xs = [rng.standard_normal((N,) + s).astype(np.float32) for s in sizes]
    alive = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
    _assert_runs_equal(tcp, jcp, mesh8, xs + [alive])
    with LocalMesh({"data": N}, device="cpu"):
        got = tcp(*map(torch.from_numpy, xs + [alive]))
    live = alive != 0
    np.testing.assert_allclose(got[0].numpy()[0],
                               xs[0][live].sum(0) / live.sum(), atol=1e-5)
