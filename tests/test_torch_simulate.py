"""repro_torch.cgra.simulate (SwitchSim) against the JAX reference's
simulator and against the port's own executed program.

Each case compiles one program in both packages from the same local
avals, feeds one seeded numpy input to the reference's ``SwitchSim``
(numpy per rank on the host) and to the port's (rank-stacked CPU
tensors, the kernels' plain versions), and demands

  * outputs bitwise equal to the reference simulator's, and to the port's
    compiled program executed on a CPU ``LocalMesh`` whose rank dims are
    the simulator's grid;
  * every ``SimReport`` field exactly equal (``t_sim``, ``t_model``,
    ``t_start``, ``t_ser``, ``wave`` per stage, ``t_end``,
    ``t_program_model``, ``rank_t_end``): the port's clock is the
    reference's float64 arithmetic, operation for operation.  For a
    program with an R1 stage the reference runs on a copy carrying the
    port's placements (``sim_parity.with_port_placements``).

Compressed syncs use planted-peak data (every 256-lane block peaks at
``127·2^k``); ``topk`` uses signed distinct integers, where every fold
order gives the same bits and no magnitude ties at the k-th place (the
reference's ``argsort`` is not stable).  A random-float inclusive scan is
held to the f32 rounding bound: numpy's ``cumsum`` and torch's differ in
their accumulation, so it is bitwise on integer-valued data only.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.core.wire import BF16 as JBF16
from repro.core.wire import FP8 as JFP8
from repro_torch import core as T
from repro_torch.core.wire import BF16 as TBF16
from repro_torch.core.wire import FP8 as TFP8
from repro_torch.cgra import FaultPlan, SimReport, SwitchSim
from repro_torch.cgra.simulate import ring_reduce_scatter
from repro_torch.core.types import ADD, MAX, MIN
from repro_torch.kernels import fused_combine as fc
from repro_torch.mesh import LocalMesh
from sim_parity import (assert_bitwise, assert_parity, assert_same_report,
                        avals, compile_pair, distinct_integers, executed,
                        planted, sim_pair)

N = 8
LOCAL = (4, 33)


# ---------------------------------------------------------------------------
# the stacked ring walk: every rank of every ring in one combine a step
# ---------------------------------------------------------------------------

def _per_rank_rs(blocks, combine):
    """The reference's per-rank loop (``SwitchSim._ring_rs``) on one
    ring of torch blocks."""
    n = len(blocks)
    chunks = [torch.chunk(b, n, dim=0) for b in blocks]
    buf = [chunks[i][(i - 1) % n] for i in range(n)]
    for s in range(n - 1):
        incoming = [buf[(i - 1) % n] for i in range(n)]
        buf = [combine(incoming[i], chunks[i][(i - 2 - s) % n])
               for i in range(n)]
    return buf


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("monoid", [ADD, MAX, MIN], ids=lambda m: m.name)
def test_stacked_ring_walk_matches_per_rank_loop(monoid, dtype):
    """3 rings × 4 ranks: one ``fused_combine`` call a step over all 12
    ranks gives each rank's per-rank fold bit for bit (incoming first, the
    chunk walk of ``ring.ring_reduce_scatter``)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 4, 4 * 5, 3), generator=g).to(dtype)
    calls = []

    def combine(a, b):
        calls.append(a.shape)
        return fc.fused_combine(a.contiguous(), b.contiguous(),
                                op=monoid.name)

    got = ring_reduce_scatter(x, combine)
    assert len(calls) == 3 and all(c == (3, 4, 5, 3) for c in calls)
    for r in range(3):
        want = _per_rank_rs(list(x[r]), monoid.combine)
        for i in range(4):
            assert_bitwise(got[r, i].float(), want[i].float())


def test_two_axis_ring_views_round_trip():
    """``_ring_view``/``_unring`` follow the reference's ``_rings``: on
    {data: 4, pod: 2} a data ring is a column of the grid, a pod ring a
    row, and the view inverts exactly."""
    sim = SwitchSim({"data": 4, "pod": 2}, use_kernels=False)
    ids = torch.arange(8 * 3).reshape(8, 3)
    for axis in ("data", "pod"):
        view = sim._ring_view(ids, axis)
        rings = sim._rings(axis)
        assert view.shape[:2] == (len(rings), len(rings[0]))
        for g, ranks in enumerate(rings):
            assert torch.equal(view[g, :, 0] // 3,
                               torch.as_tensor(ranks))
        assert torch.equal(sim._unring(view, axis), ids)


# ---------------------------------------------------------------------------
# acceptance: four backends, simulator vs executed program vs reference
# ---------------------------------------------------------------------------

def _sync_program(backend, n_total):
    """A gradient-sync-shaped program (EF target/mean/residual on the
    compressed backends) with an explicit divisor, built per package."""
    compressed = "compressed" in backend

    def make(a):
        def sync(g, r):
            t = a.map(lambda g_, r_: g_ + r_, g, r, name="ef_target")
            if compressed:
                red, dlv = a.ef_reduce(t, axis="auto")
                out = a.map(lambda y: y / n_total, red, name="mean")
                res = a.map(lambda t_, d: t_ - d, t, dlv,
                            name="ef_residual")
                return out, res
            red = a.reduce(t, axis="auto")
            return a.map(lambda y: y / n_total, red, name="mean"), t
        return sync
    return make


CASES = [("acis", None, {"data": N}, None)] + [
    ("acis_compressed", c, {"data": N}, None)
    for c in ("int8", "int8_hopquant", "topk")] + [
    (b, c, sizes, "pod")
    for sizes in ({"data": 2, "pod": 2}, {"data": 4, "pod": 2})
    for b, c in (("acis_hierarchical", None),
                 ("acis_hierarchical_compressed", "int8"),
                 ("acis_hierarchical_compressed", "int8_hopquant"),
                 ("acis_hierarchical_compressed", "topk"))]


@pytest.mark.parametrize(
    "backend,compressor,sizes,outer", CASES,
    ids=[f"{b}-{c or 'plain'}-{'x'.join(map(str, s.values()))}"
         for b, c, s, _ in CASES])
def test_simulator_matches_reference_and_executed(backend, compressor,
                                                  sizes, outer, rng):
    n_total = int(np.prod(list(sizes.values())))
    cfg = {"compressor": compressor} if compressor else {}
    tc, jc = compile_pair(_sync_program(backend, n_total), [LOCAL, LOCAL],
                          sizes, backend=backend, outer=outer, **cfg)
    grid = tuple(sizes.values())
    if compressor == "topk":
        g = distinct_integers(rng, (n_total,) + LOCAL)
        r = np.zeros_like(g)
    elif compressor:
        g = planted(rng, (n_total,) + LOCAL)
        r = np.zeros_like(g)
    else:
        g = rng.standard_normal((n_total,) + LOCAL).astype(np.float32)
        r = 0.01 * rng.standard_normal((n_total,) + LOCAL) \
            .astype(np.float32)
    xs = [g.reshape(grid + LOCAL), r.reshape(grid + LOCAL)]
    (out, res), rep, _ = assert_parity(tc, jc, xs)
    assert isinstance(rep, SimReport)
    assert len(rep.stages) == len(tc.stages)
    assert rep.t_sim > 0 and rep.t_model > 0
    for srow, st in zip(rep.stages, tc.stages):
        assert srow.kind == st.kind and srow.t_sim >= 0
        assert srow.placement is st.placement
    if compressor != "topk":       # top-k sums a 1% sparsification
        want = (g + r).reshape(n_total, -1).mean(0).reshape(LOCAL)
        np.testing.assert_allclose(out.reshape((-1,) + LOCAL)[0].numpy(),
                                   want, atol=5e-2 if compressor else 1e-5)


# ---------------------------------------------------------------------------
# individual stage kinds
# ---------------------------------------------------------------------------

def _prog(fn):
    return lambda a: (lambda *xs: fn(a, *xs))


def test_fig5_scan_allgather(rng):
    tc, jc = compile_pair(
        _prog(lambda a, x: a.all_gather(a.scan(a.all_gather(x)))),
        [(8,)], N)
    assert tc.stage_kinds() == ["scan+allgather"]
    ints = rng.integers(-50, 50, (N, 8)).astype(np.float32)
    (got,), _, _ = assert_parity(tc, jc, [ints])
    assert torch.equal(got[0], torch.from_numpy(np.cumsum(ints.reshape(-1))))
    x = rng.standard_normal((N, 8)).astype(np.float32)
    (t, trep), (j, jrep), sim = sim_pair(tc, jc, [x])
    assert_same_report(trep, jrep)
    exact = np.cumsum(x.reshape(-1).astype(np.float64))
    bound = 2.0 ** -23 * np.cumsum(np.abs(x.reshape(-1)).astype(np.float64)) \
        * np.arange(1, x.size + 1)
    for row in t[0].numpy():
        assert np.all(np.abs(row - exact) <= bound)
    assert np.all(np.abs(np.asarray(j[0])[0] - exact) <= bound)


def test_nas_is_pair(rng):
    tc, jc = compile_pair(
        _prog(lambda a, h, k: (a.reduce(h), a.all_to_all(k))),
        [(16,), (64,)], N)
    assert tc.stage_kinds() == ["allreduce+alltoall"]
    h = rng.standard_normal((N, 16)).astype(np.float32)
    k = rng.standard_normal((N, 64)).astype(np.float32)
    (gh, gk), _, _ = assert_parity(tc, jc, [h, k])
    np.testing.assert_allclose(gh[0].numpy(), h.sum(0), atol=1e-5)
    assert torch.equal(gk[3], torch.from_numpy(
        k.reshape(N, N, 8)[:, 3].reshape(-1)))


def test_bcast_allreduce_map_chain(rng):
    tc, jc = compile_pair(_prog(lambda a, x: a.map(
        lambda v: v + 1, a.all_gather(a.reduce_scatter(a.bcast(x, root=3))),
        name="inc")), [(16,)], N)
    x = rng.standard_normal((N, 16)).astype(np.float32)
    (got,), _, _ = assert_parity(tc, jc, [x])
    np.testing.assert_allclose(got[5].numpy(), N * x[3] + 1, atol=1e-5)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("codec", ["bf16", "fp8"])
def test_wire_codec_reduce(rng, codec, use_kernels):
    """A cast codec on the ring's wire.  F3: with kernels on, the port's
    executed ring sent an fp8 wire's hops to the kernel's plain version,
    which has no fp8 add (and the CUDA kernel takes no fp8); an fp8 hop
    now computes in f32 through the kernel and rounds once to fp8, as the
    monoid's own combine does — bitwise the reference's simulator."""
    tcodec = {"bf16": TBF16, "fp8": TFP8}[codec]
    jcodec = {"bf16": JBF16, "fp8": JFP8}[codec]
    tc, jc = compile_pair(
        lambda a: (lambda x: a.reduce(a.wire(tcodec if a is T else jcodec,
                                             x))), [(32,)], N,
        use_kernels=use_kernels)
    x = rng.standard_normal((N, 32)).astype(np.float32)
    (got,), _, _ = assert_parity(tc, jc, [x])
    np.testing.assert_allclose(got[0].numpy(), x.sum(0),
                               atol=5e-2 if codec == "bf16" else 1.5)


def test_ef_topk_matches(rng):
    tc, jc = compile_pair(
        _prog(lambda a, x: a.ef_reduce(x, axis="data", compressor="topk",
                                       topk_ratio=0.1)[0]),
        [(4, 32)], N, backend="acis_compressed", compressor="topk")
    x = distinct_integers(rng, (N, 4, 32))
    (got,), rep, _ = assert_parity(tc, jc, [x])
    # every rank's 12 largest magnitudes, summed over the ranks
    flat = x.reshape(N, -1)
    dense = np.zeros(flat.shape[1], np.float32)
    for row in flat:
        top = np.argsort(-np.abs(row), kind="stable")[:12]
        dense[top] += row[top]
    assert_bitwise(got[0].reshape(-1), dense)
    assert rep.stages[0].t_sim > 0


# ---------------------------------------------------------------------------
# latency accounting
# ---------------------------------------------------------------------------

def test_simulated_time_tracks_analytic_model(rng):
    """Not a bit-match between the DES and the closed form — they make
    different pipelining assumptions — but the same order of magnitude,
    and the same numbers as the reference's report."""
    tc, jc = compile_pair(_prog(lambda a, x: a.reduce(x)), [(1 << 14,)], N)
    x = rng.standard_normal((N, 1 << 14)).astype(np.float32)
    _, rep, _ = assert_parity(tc, jc, [x])
    (row,) = rep.stages
    assert row.t_model is not None
    assert 0.2 < row.t_sim / row.t_model < 5.0


def test_outer_dci_stage_costs_more_than_inner(rng):
    tc, jc = compile_pair(
        _prog(lambda a, x: a.all_gather(a.reduce_scatter(x, axis="data"),
                                        axis="pod")),
        [(8, 32)], {"data": 2, "pod": 2}, backend="acis_hierarchical",
        outer="pod")
    assert tc.stage_axes() == ["data", "pod"]
    x = rng.standard_normal((2, 2, 8, 32)).astype(np.float32)
    _, rep, _ = assert_parity(tc, jc, [x])
    by_axis = {r.axis: r for r in rep.stages}
    assert by_axis["pod"].t_sim > by_axis["data"].t_sim


def test_fallback_stage_slower_than_placed(rng):
    """The same program on a too-small device simulates slower (the host
    detour is charged), with the same numerics and the reference's
    numbers."""
    from repro.cgra.device import CGRADevice as JDev
    from repro.cgra.mapper import PlaceCGRA as JPlace
    from repro.core import compiler as jcomp
    from repro_torch.cgra.device import CGRADevice
    from repro_torch.core import compiler as tcomp

    def build(comp, place, device, a, av, tanh):
        pipeline = (comp.Legalize(), comp.LowerTopology(), comp.FuseHops(),
                    comp.SelectSchedule(), place(device=device),
                    comp.Emit())
        return comp.compile_rank_local(
            lambda x: a.reduce(a.map(lambda v: tanh(v) * 2, x,
                                     name="body")),
            "data", axis_size=N, in_avals=(av,), pipeline=pipeline)

    (jav,), (tav,) = avals([(1 << 12,)])
    reps, outs = {}, {}
    x = np.random.default_rng(0).standard_normal((N, 1 << 12)) \
        .astype(np.float32)
    for name, dev in (("big", {}), ("tiny", dict(rows=1, cols=1,
                                                 ops_per_pe=1))):
        tc = build(tcomp, tcomp.PlaceCGRA, CGRADevice(**dev), T, tav,
                   torch.tanh)
        jc = build(jcomp, JPlace, JDev(**dev), J, jav, jnp.tanh)
        # XLA's tanh and torch's differ in the last bit: the outputs are
        # held to the executed program bitwise and to the reference's
        # within f32 rounding; the report equals the reference's exactly
        (t, trep), (j, jrep), sim = sim_pair(tc, jc, [x])
        assert_same_report(trep, jrep)
        assert_bitwise(t[0], executed(tc, sim, [x])[0])
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]),
                                   rtol=1e-6, atol=1e-5)
        outs[name], reps[name] = t[0], trep
        assert tc.stages[0].placement.fits == (name == "big")
    assert reps["tiny"].t_sim > reps["big"].t_sim
    assert torch.equal(outs["big"], outs["tiny"])


def test_report_table_renders():
    tc, jc = compile_pair(_prog(lambda a, x: a.reduce(x)), [(64,)], N)
    x = np.ones((N, 64), np.float32)
    (_, trep), (_, jrep), _ = sim_pair(tc, jc, [x])
    txt = trep.table()
    assert "sim_us" in txt and "model_us" in txt and "TOTAL" in txt
    assert txt == jrep.table()


def test_input_grid_validation():
    tc = T.make_engine("acis").compile(lambda x: T.reduce(x))
    sim = SwitchSim({"data": N}, use_kernels=False)
    with pytest.raises(ValueError, match="rank grid"):
        sim.run(tc, torch.ones((3, 4)))
    with pytest.raises(TypeError, match="inputs"):
        sim.run(tc)


def test_sim_requires_default_pipeline_stage_ir():
    tc = T.make_engine("acis").compile(lambda x: T.reduce(x))
    tc.stages = [dataclasses.replace(tc.stages[0], ir=None)]
    with pytest.raises(ValueError, match="StageIR"):
        SwitchSim({"data": N}).run(tc, torch.ones((N, 4)))


def test_fused_exclusive_scan_matches_reference(rng):
    """The fused scan+allgather honours ``exclusive`` (rank 0 gets the
    monoid identity block), bitwise — the blockwise walk keeps the
    reference's fold order."""
    tc, jc = compile_pair(
        _prog(lambda a, x: a.all_gather(a.scan(a.all_gather(x),
                                               exclusive=True))),
        [(4,)], N)
    assert tc.stage_kinds() == ["scan+allgather"]
    # random data: bitwise the reference simulator's blockwise walk; the
    # executed program scans in log steps (another fold order), so it is
    # held bitwise on integer-valued data and within rounding here
    x = rng.standard_normal((N, 4)).astype(np.float32)
    (got,), _, _ = assert_parity(tc, jc, [x], exec_bitwise=False)
    assert torch.equal(got[0, :4], torch.zeros(4))
    (t, _), _, sim = sim_pair(tc, jc, [x])
    np.testing.assert_allclose(t[0].numpy(),
                               executed(tc, sim, [x])[0].numpy(), atol=1e-5)
    ints = rng.integers(-50, 50, (N, 4)).astype(np.float32)
    assert_parity(tc, jc, [ints])


def test_numpy_inputs_go_to_the_card():
    """A numpy input is placed on the card (``default_device``), which
    raises here; CPU tensors stay on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    tc = T.make_engine("acis").compile(lambda x: T.reduce(x))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SwitchSim({"data": N}).run(tc, np.ones((N, 4), np.float32))
    out, _ = SwitchSim({"data": N}).run(tc, torch.ones((N, 4)))
    assert out.device.type == "cpu"


def test_fault_plan_is_the_references():
    plan = FaultPlan(dead={3, 1}, straggler_s={2: 1e-6},
                     degraded_links={"data": 2.0})
    assert plan.dead == frozenset({1, 3})
    assert plan.straggler_s == ((2, 1e-6),)
    assert plan.degraded_links == (("data", 2.0),)
    assert bool(plan) and not FaultPlan()


# ---------------------------------------------------------------------------
# on the card (skips here): kernels against plain versions, launches counted
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_sim_kernels_match_plain_on_the_card(rng):
    """SwitchSim with kernels on the card: one ``fused_combine`` launch a
    ring step, bitwise the plain simulation and the executed program."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tc, _ = compile_pair(_sync_program("acis", N), [LOCAL, LOCAL], {"data": N})
    xs = [torch.from_numpy(rng.standard_normal((N,) + LOCAL)
                           .astype(np.float32)).cuda() for _ in range(2)]
    n0 = fc.launches
    (ok, rk), rep = SwitchSim(tc.topology, use_kernels=True).run(tc, *xs)
    assert fc.launches - n0 == N - 1
    (op, rp), _ = SwitchSim(tc.topology, use_kernels=False).run(tc, *xs)
    assert torch.equal(ok, op) and torch.equal(rk, rp)
    with LocalMesh({"data": N}, device="cuda"):
        eo, er = tc(*xs)
    assert torch.equal(ok, eo) and torch.equal(rk, er)
