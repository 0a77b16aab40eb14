"""repro_torch.elastic (Membership, sync_with_deadline, TopologyDelta), the
engine's ``recompile`` and ``gradient_sync(membership=...)``, and the
masked reduce, against the JAX reference (``tests/test_elastic.py`` and
``tests/test_masked_reduce.py``).

Verdicts, outcomes, reports and counters equal the reference's.  The
masked sync is bitwise the reference's on all five backends (the
compressed ones on planted-peak data), on the conftest's 8 host devices
as a 2 × 2 ``("pod", "data")`` mesh against ``LocalMesh({"pod": 2,
"data": 2}, device="cpu")``.

R1: on jax 0.9 the reference's masked pack falls back to the host, which
fails its own placement and overhead tests
(``test_masked_reduce.py::test_masked_epilogues_place_on_cgra`` and
``::test_masked_sync_overhead_gate``).  The port is held to what those
tests intend — every masked epilogue on the switch, the masked sync
within 5% of a plain one — beside the reference's actual fallback.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import core as J
from repro.cgra.device import HostFallback as JHostFallback
from repro.cgra.simulate import FaultPlan as JFaultPlan
from repro.core.api import RecompileReport as JRecompileReport
from repro.elastic import Membership as JMembership
from repro.elastic import sync_with_deadline as j_sync_with_deadline
from repro.obs import metrics as jobs
from repro_torch import core as T
from repro_torch.cgra.device import HostFallback
from repro_torch.cgra.simulate import FaultPlan
from repro_torch.core.api import RecompileReport
from repro_torch.elastic import (ElasticSyncError, Membership, TopologyDelta,
                                 deadline_verdicts, sync_with_deadline)
from repro_torch.mesh import LocalMesh
from repro_torch.obs import metrics as obs
from sim_parity import (assert_bitwise, assert_same_report, compile_pair,
                        planted, sim_pair)

BACKENDS = ["acis", "acis_compressed", "acis_hierarchical",
            "acis_hierarchical_compressed"]


@pytest.fixture(scope="module")
def mesh22():
    return jax.make_mesh((2, 2), ("pod", "data"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def smap(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


# ---------------------------------------------------------------------------
# Membership
# ---------------------------------------------------------------------------

def test_membership_views_and_updates():
    m = Membership.all_alive(4)
    assert m.n_ranks == 4 and m.n_alive == 4 and m.dead == ()
    m2 = m.drop(1, 3)
    assert m2.alive == (True, False, True, False)
    assert m2.dead == (1, 3) and m2.n_alive == 2
    assert m2.restore(3).alive == (True, False, True, True)
    assert m.drop(0).merge(m.drop(2)).dead == (0, 2)
    mask = m2.mask_array()
    assert isinstance(mask, torch.Tensor) and mask.dtype == torch.float32
    assert torch.equal(mask, torch.tensor([1.0, 0.0, 1.0, 0.0]))
    assert m2.mask_array(torch.bfloat16).dtype == torch.bfloat16
    jm2 = JMembership.all_alive(4).drop(1, 3)
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(jm2.mask_array()))


def test_membership_validation():
    with pytest.raises(ValueError):
        Membership(())
    with pytest.raises(ValueError):
        Membership.all_alive(4).drop(4)
    with pytest.raises(ValueError):
        Membership.all_alive(4).merge(Membership.all_alive(3))


def test_membership_from_rank_times():
    m = Membership.from_rank_times([0.1, 0.9, 0.2, 0.3], deadline_s=0.5)
    assert m.alive == (True, False, True, True)
    merged = deadline_verdicts([0.1, 0.1, 0.1, 0.1], 0.5, membership=m)
    assert merged.alive == m.alive


def test_delta_classifies_and_counts():
    with obs.recording() as rec:
        d = Membership.all_alive(4).delta(Membership.all_alive(4).drop(2))
    assert d.dropped == (2,) and d.restored == ()
    assert d.shape_preserving and bool(d)
    assert rec.counter("elastic.rank_dropped") == 1

    d2 = Membership.all_alive(4).drop(1).delta(Membership.all_alive(4))
    assert d2.restored == (1,) and d2.shape_preserving

    moving = Membership.all_alive(4).delta(Membership.all_alive(4),
                                           axis_sizes={"data": 2})
    assert not moving.shape_preserving
    assert not bool(TopologyDelta())


# ---------------------------------------------------------------------------
# sync_with_deadline (outcomes held to the reference's)
# ---------------------------------------------------------------------------

def _runner(times_per_attempt):
    """Fake sync: returns canned per-rank times, result = attempt no."""
    calls = []

    def run(membership, deadline):
        calls.append((membership, deadline))
        times = times_per_attempt[min(len(calls) - 1,
                                      len(times_per_attempt) - 1)]
        return len(calls), times
    return run, calls


def _both(times, n, **kw):
    """The port's and the reference's outcome on the same canned times
    (or the same error)."""
    outs = []
    for mem, fn in ((Membership, sync_with_deadline),
                    (JMembership, j_sync_with_deadline)):
        run, _ = _runner(times)
        try:
            o = fn(run, mem.all_alive(n), **kw)
            outs.append((o.result, o.membership.alive, o.attempts,
                         o.deadline_s, o.masked))
        except Exception as e:          # noqa: BLE001 — compared below
            outs.append((type(e).__name__, str(e)))
    assert outs[0] == outs[1]
    return outs[0]


def test_sync_clean_first_attempt():
    run, calls = _runner([[0.1, 0.2, 0.1, 0.2]])
    out = sync_with_deadline(run, Membership.all_alive(4), deadline_s=0.5)
    assert out.result == 1 and out.attempts == 1 and out.masked == ()
    assert out.membership.n_alive == 4
    assert calls[0][1] == 0.5
    _both([[0.1, 0.2, 0.1, 0.2]], 4, deadline_s=0.5)


def test_sync_masks_late_rank_and_backs_off():
    run, calls = _runner([[0.1, 9.0, 0.1, 0.1], [0.1, 9.0, 0.1, 0.1]])
    with obs.recording() as rec:
        out = sync_with_deadline(run, Membership.all_alive(4),
                                 deadline_s=0.5, backoff=2.0)
    assert out.attempts == 2 and out.masked == (1,)
    assert out.membership.dead == (1,)
    assert out.deadline_s == 1.0
    assert calls[1][0].dead == (1,)
    assert rec.counter("elastic.deadline_miss") == 1
    assert rec.counter("elastic.retry") == 1
    _both([[0.1, 9.0, 0.1, 0.1], [0.1, 9.0, 0.1, 0.1]], 4,
          deadline_s=0.5, backoff=2.0)


def test_sync_result_never_mixes_attempts():
    run, _ = _runner([[9.0, 0.1], [0.1, 0.1]])
    out = sync_with_deadline(run, Membership.all_alive(2), deadline_s=1.0)
    assert out.result == 2
    _both([[9.0, 0.1], [0.1, 0.1]], 2, deadline_s=1.0)


def test_sync_exhausts_retries():
    with pytest.raises(ElasticSyncError):
        sync_with_deadline(_runner([[9.0, 9.0, 9.0]])[0],
                           Membership.all_alive(3),
                           deadline_s=0.5, max_retries=2)
    got = _both([[9.0, 9.0, 9.0]], 3, deadline_s=0.5, max_retries=2)
    assert got[0] == "ElasticSyncError"


def test_sync_all_dead_raises():
    run, _ = _runner([[9.0, 9.0]])
    with pytest.raises(ElasticSyncError, match="deadline"):
        sync_with_deadline(run, Membership.all_alive(2), deadline_s=0.5)
    with pytest.raises(ElasticSyncError, match="no alive"):
        sync_with_deadline(run, Membership.all_alive(2).drop(0, 1),
                           deadline_s=0.5)


def test_sync_with_deadline_over_simulated_rank_times(rng):
    """The control loop driven by ``SwitchSim`` rank times: rank 5
    straggles (its delay is added to every hop it receives, so it
    finishes last), the deadline falls between it and the rest, so it is
    masked once and the retry — rank 5 dead, its ring contracted — runs
    clean.  The same outcome, attempts and masked ranks as the
    reference's loop over its simulator, reports exactly equal, and the
    live ranks' mean is the masked mean."""
    n = 8
    tc, jc = compile_pair(
        lambda a: (lambda x, alive: a.masked_reduce(x, alive, axis="auto")),
        [(256,), ()], n)
    x = rng.standard_normal((n, 256)).astype(np.float32)
    ones = np.ones(n, np.float32)
    (_, rep0), _, _ = sim_pair(tc, jc, [x, ones])
    straggle = {"straggler_s": ((5, rep0.t_end),)}
    (_, slow), _, _ = sim_pair(tc, jc, [x, ones],
                               faults=FaultPlan(**straggle),
                               jfaults=JFaultPlan(**straggle))
    others = max(t for r, t in enumerate(slow.rank_t_end) if r != 5)
    assert slow.rank_t_end[5] > others
    deadline = 0.5 * (others + slow.rank_t_end[5])

    def runner(port: bool):
        def run(mem, _deadline):
            alive = np.asarray(mem.alive, np.float32)
            kw = straggle if mem.alive[5] else {"dead": frozenset({5})}
            (tout, trep), (jout, jrep), _ = sim_pair(
                tc, jc, [x, alive], faults=FaultPlan(**kw),
                jfaults=JFaultPlan(**kw))
            assert_same_report(trep, jrep)
            for t, j in zip(tout, jout):
                assert_bitwise(t, j)
            return ((tout, trep.rank_t_end) if port
                    else (jout, jrep.rank_t_end))
        return run

    out = sync_with_deadline(runner(True), Membership.all_alive(n),
                             deadline_s=deadline)
    jout = j_sync_with_deadline(runner(False), JMembership.all_alive(n),
                                deadline_s=deadline)
    assert (out.attempts, out.masked, out.membership.alive,
            out.deadline_s) == (jout.attempts, jout.masked,
                                jout.membership.alive, jout.deadline_s)
    assert out.attempts == 2 and out.masked == (5,)
    live = np.ones(n, bool)
    live[5] = False
    np.testing.assert_allclose(out.result[0][0].numpy(), x[live].mean(0),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# engine.recompile (reports and counters held to the reference's)
# ---------------------------------------------------------------------------

def _grads(mesh):
    return {"w": torch.zeros(mesh.rank_shape + (96,)),
            "b": torch.zeros(mesh.rank_shape + (7,))}


def _jgrads():
    return {"w": jnp.zeros((96,), jnp.float32),
            "b": jnp.zeros((7,), jnp.float32)}


def test_recompile_shape_preserving_reuses_everything():
    eng = T.make_engine("acis_hierarchical", inner_axis="data",
                        outer_axis="pod")
    jeng = J.make_engine("acis_hierarchical", inner_axis="data",
                         outer_axis="pod")
    mesh = LocalMesh({"pod": 2, "data": 4}, device="cpu")
    sizes = {"data": 4, "pod": 2}
    gl = _grads(mesh)
    eng.init_arenas(gl, mesh=mesh, masked=True)          # warm caches
    jeng.init_arenas(_jgrads(), axis_sizes=sizes, masked=True)
    mem, jmem = Membership.all_alive(8), JMembership.all_alive(8)
    for r in (1, 5):
        rep = eng.recompile(mem.delta(mem.drop(r)), gl, mesh=mesh)
        jrep = jeng.recompile(jmem.delta(jmem.drop(r)), _jgrads(),
                              axis_sizes=sizes)
        assert isinstance(rep, RecompileReport)
        assert rep.programs_reused == 1 and rep.programs_rebuilt == 0
        assert rep.arenas_rebuilt == 0
        assert rep.shape_preserving and not rep.full_recompile
        assert rep.reuse_frac == 1.0
        assert isinstance(jrep, JRecompileReport)
        assert (rep.programs_reused, rep.programs_rebuilt,
                rep.arenas_reused, rep.arenas_rebuilt,
                rep.shape_preserving) == (
            jrep.programs_reused, jrep.programs_rebuilt,
            jrep.arenas_reused, jrep.arenas_rebuilt,
            jrep.shape_preserving)


def test_recompile_shape_moving_compiles_fresh():
    eng = T.make_engine("acis", inner_axis="data")
    jeng = J.make_engine("acis", inner_axis="data")
    mesh = LocalMesh({"data": 4}, device="cpu")
    gl = _grads(mesh)
    eng.init_arenas(gl, mesh=mesh, masked=True)
    jeng.init_arenas(_jgrads(), axis_sizes={"data": 4}, masked=True)
    delta = TopologyDelta(axis_sizes=(("data", 8),))
    rep = eng.recompile(delta, gl, mesh=mesh)
    jrep = jeng.recompile(delta, _jgrads(), axis_sizes={"data": 4})
    assert not rep.shape_preserving
    assert rep.full_recompile and rep.programs_rebuilt == 1
    assert (rep.programs_rebuilt, rep.arenas_rebuilt, rep.full_recompile) \
        == (jrep.programs_rebuilt, jrep.arenas_rebuilt, jrep.full_recompile)


def test_recompile_emits_counters():
    eng = T.make_engine("acis", inner_axis="data")
    jeng = J.make_engine("acis", inner_axis="data")
    mesh = LocalMesh({"data": 8}, device="cpu")
    gl = _grads(mesh)
    eng.init_arenas(gl, mesh=mesh, masked=True)
    jeng.init_arenas(_jgrads(), axis_sizes={"data": 8}, masked=True)
    mem = Membership.all_alive(8)
    with obs.recording() as rec:
        eng.recompile(mem.delta(mem.drop(3)), gl, mesh=mesh)
    with jobs.recording() as jrec:
        jmem = JMembership.all_alive(8)
        jeng.recompile(jmem.delta(jmem.drop(3)), _jgrads(),
                       axis_sizes={"data": 8})
    assert rec.counter("recompile.programs_reused") == 1
    assert rec.counter("recompile.programs_rebuilt") == 0
    events = [f for n, f in rec.events if n == "engine.recompile"]
    assert events and events[0]["shape_preserving"]
    assert rec.snapshot()["counters"] == jrec.snapshot()["counters"]
    assert rec.events == jrec.events


# ---------------------------------------------------------------------------
# the masked reduce (tests/test_masked_reduce.py)
# ---------------------------------------------------------------------------

def _masked_pair(n=8, size=64, monoid="add", renormalize=True,
                 backend="acis", outer=None, sizes=None):
    def make(a):
        m = getattr(a, monoid.upper())
        return lambda x, alive: a.masked_reduce(
            x, alive, m, axis="auto", renormalize=renormalize)
    return compile_pair(make, [(size,), ()], sizes or n, backend=backend,
                        outer=outer)


def _ref_masked(jc, x, alive):
    mesh8 = jax.make_mesh((8,), ("data",),
                          axis_types=(jax.sharding.AxisType.Auto,))

    def f(xl, al):
        v, c = jc(xl[0], al[0].reshape(()))
        return v[None], c.reshape(1)
    return smap(f, mesh8, (JP("data", None), JP("data")),
                (JP("data", None), JP("data")))(jnp.asarray(x),
                                                jnp.asarray(alive))


def _port_masked(tc, x, alive):
    with LocalMesh({"data": 8}, device="cpu"):
        return tc(torch.from_numpy(x), torch.from_numpy(alive))


def test_masked_mean_matches_reference(rng):
    x = rng.standard_normal((8, 64)).astype(np.float32)
    alive = np.array([1, 0, 1, 1, 1, 0, 1, 1], np.float32)
    tc, jc = _masked_pair()
    v, c = _port_masked(tc, x, alive)
    jv, jcnt = _ref_masked(jc, x, alive)
    assert_bitwise(v, jv)
    assert_bitwise(c, jcnt)
    np.testing.assert_allclose(v[0].numpy(), x[alive != 0].mean(0),
                               atol=1e-5)
    assert torch.all(c == 6.0)


def test_masked_max_uses_monoid_identity(rng):
    """Dead ranks contribute the monoid identity (-inf for max), not
    zero; the count lane folds under the same monoid (any-alive)."""
    x = rng.standard_normal((8, 16)).astype(np.float32)
    x[3] += 100.0
    alive = np.ones(8, np.float32)
    alive[3] = 0.0
    tc, jc = _masked_pair(size=16, monoid="max", renormalize=False)
    v, c = _port_masked(tc, x, alive)
    jv, jcnt = _ref_masked(jc, x, alive)
    assert_bitwise(v, jv)
    assert_bitwise(c, jcnt)
    assert torch.equal(v[0], torch.from_numpy(x[alive != 0].max(axis=0)))
    assert torch.all(c == 1.0)


def test_all_dead_clamps_count():
    tc, jc = _masked_pair(size=8)
    x = np.ones((8, 8), np.float32)
    v, c = _port_masked(tc, x, np.zeros(8, np.float32))
    assert torch.all(torch.isfinite(v))
    assert torch.all(c == 1.0)
    jv, jcnt = _ref_masked(jc, x, np.zeros(8, np.float32))
    assert_bitwise(v, jv)


def test_renormalize_requires_add():
    with pytest.raises(ValueError, match="renormaliz"):
        _masked_pair(monoid="max", renormalize=True)


def test_flat_masked_is_one_ring():
    tc, jc = _masked_pair()
    kinds = tc.stage_kinds()
    assert kinds.count("allreduce") == 1, kinds
    assert kinds == ["map", "allreduce", "map", "map"] == jc.stage_kinds()


def test_hierarchical_masked_is_one_pipeline():
    tc, jc = _masked_pair(backend="acis_hierarchical", outer="pod",
                          sizes={"data": 4, "pod": 2})
    colls = [k for k in tc.stage_kinds()
             if k in ("reduce_scatter", "allreduce", "allgather")]
    assert colls == ["reduce_scatter", "allreduce", "allgather"]
    assert tc.stage_kinds() == jc.stage_kinds()


def test_bucketed_masked_leaves_share_one_ring():
    def make(a):
        def prog(p, q, r, alive):
            va, _ = a.masked_reduce(p, alive, axis="auto")
            vb, _ = a.masked_reduce(q, alive, axis="auto")
            vc, _ = a.masked_reduce(r, alive, axis="auto")
            return va, vb, vc
        return prog
    tc, jc = compile_pair(make, [(32,), (48,), (16,), ()], 8)
    assert tc.stage_kinds().count("allreduce") == 1
    assert tc.stage_kinds() == jc.stage_kinds()


def test_masked_epilogues_place_on_cgra():
    """R1, held to the reference's intent: the pack and renorm epilogues
    stay on the switch in the port (the reference's pack falls back on
    jax 0.9's nested ``jit``)."""
    for backend, kw in (("acis", {}),
                        ("acis_hierarchical",
                         {"outer": "pod", "sizes": {"data": 4, "pod": 2}})):
        tc, jc = _masked_pair(backend=backend, size=4096, **kw)
        fellback = [s.placement.reason for s in tc.stages
                    if isinstance(s.placement, HostFallback)]
        assert not fellback, (backend, fellback)
        jfell = [s.placement.reason for s in jc.stages
                 if isinstance(s.placement, JHostFallback)]
        assert all("'jit'" in r for r in jfell)


def _sync_programs(eng, masked):
    from repro_torch import tree
    from repro_torch.core.types import TensorSpec
    leaves, treedef = tree.tree_flatten({"w": torch.zeros(4096),
                                         "b": torch.zeros(128)})
    avals = tuple(TensorSpec(tuple(l.shape), l.dtype) for l in leaves)
    return eng._sync_program(treedef, avals, None, axis_sizes={"data": 8},
                             masked=masked)


def test_masked_sync_overhead_gate():
    """R1, held to the reference's intent: at zero faults the engine's
    masked sync prices within 5% of the unmasked one."""
    eng = T.make_engine("acis", inner_axis="data")
    t_plain = _sync_programs(eng, masked=False).program_time()
    t_masked = _sync_programs(eng, masked=True).program_time()
    assert t_masked <= 1.05 * t_plain, (t_masked, t_plain)


def test_plan_staggers_same_axis_rings():
    def make(a):
        def prog(p, q, alive):
            va, _ = a.masked_reduce(p, alive, axis="auto")
            vb, _ = a.masked_reduce(q, alive, axis="auto")
            return va, vb
        return prog
    tc, jc = compile_pair(make, [(1 << 18,), (1 << 17,), ()], 8)
    plan = tc.plan
    for wave in plan.waves:
        axes = [plan.stages[i].axis for i in wave if plan.stages[i].axis]
        assert len(axes) == len(set(axes)), plan.waves
    assert plan.waves == jc.plan.waves


def test_pipeline_levels_keep_cross_axis_waves():
    tc, jc = compile_pair(
        lambda a: (lambda x, y: (a.reduce(x, axis="data"),
                                 a.reduce(y, axis="pod"))),
        [(256,), (256,)], {"data": 4, "pod": 2}, outer="pod")
    plan = tc.plan
    coll_waves = [w for w in plan.waves
                  if sum(1 for i in w if plan.stages[i].axis) == 2]
    assert coll_waves, plan.waves
    assert plan.waves == jc.plan.waves


# ---------------------------------------------------------------------------
# gradient_sync(membership=...) across every backend
# ---------------------------------------------------------------------------

def _membership_grads(rng, backend):
    if "compressed" in backend:
        return {"w": planted(rng, (4, 33)), "b": planted(rng, (4, 5))}
    return {"w": rng.standard_normal((4, 33)).astype(np.float32),
            "b": rng.standard_normal((4, 5)).astype(np.float32)}


@pytest.mark.parametrize("backend", ["xla"] + BACKENDS)
def test_gradient_sync_membership_all_backends(mesh22, rng, backend):
    g = _membership_grads(rng, backend)
    alive = (True, False, True, True)          # rank (pod0, data1) dead
    jeng = J.make_engine(backend, inner_axis="data", outer_axis="pod")
    jmem = JMembership(alive)

    def f(wl, bl):
        grads = {"w": wl[0, 0], "b": bl[0, 0]}
        state = jeng.init_state(grads)
        synced, _ = jeng.gradient_sync(grads, state, membership=jmem)
        return synced["w"][None, None], synced["b"][None, None]

    spec = JP("pod", "data", None)
    jw, jb = smap(f, mesh22, (spec, spec), (spec, spec))(
        jnp.asarray(g["w"].reshape(2, 2, 33)),
        jnp.asarray(g["b"].reshape(2, 2, 5)))

    eng = T.make_engine(backend, inner_axis="data", outer_axis="pod")
    mesh = LocalMesh({"pod": 2, "data": 2}, device="cpu")
    grads = {k: torch.from_numpy(v.reshape((2, 2) + v.shape[1:]))
             for k, v in g.items()}
    synced, _ = eng.gradient_sync(grads, eng.init_state(grads), mesh=mesh,
                                  membership=Membership(alive))
    live = np.array(alive)
    atol = 5e-2 if "compressed" in backend else 1e-4
    np.testing.assert_allclose(synced["w"][0, 0].numpy(),
                               g["w"][live].mean(0), atol=atol)
    np.testing.assert_allclose(synced["b"][1, 1].numpy(),
                               g["b"][live].mean(0), atol=atol)
    if backend == "xla":
        # two native reductions in either package; the host devices'
        # psum and the port's per-axis sums fold differently
        np.testing.assert_allclose(synced["w"].numpy(), np.asarray(jw),
                                   rtol=1e-6, atol=1e-6)
        return
    assert_bitwise(synced["w"], jw)
    assert_bitwise(synced["b"], jb)


def test_gradient_sync_membership_is_runtime_input(rng):
    """Flipping the mask never retraces: the same compiled sync serves
    every membership (the mask rides in as a program input)."""
    g = rng.standard_normal((4, 12)).astype(np.float32)
    eng = T.make_engine("acis", inner_axis="data", outer_axis="pod")
    mesh = LocalMesh({"pod": 2, "data": 2}, device="cpu")
    grads = {"w": torch.from_numpy(g.reshape(2, 2, 12))}

    def run(mem):
        return eng.gradient_sync(grads, None, mesh=mesh,
                                 membership=mem)[0]["w"]

    run(Membership.all_alive(4))                   # warm the cache
    with obs.recording() as rec:
        for dead in (0, 1, 3):
            out = run(Membership.all_alive(4).drop(dead))
            alive = np.ones(4, bool)
            alive[dead] = False
            np.testing.assert_allclose(out[0, 0].numpy(),
                                       g[alive].mean(0), atol=1e-4)
    assert rec.counter("compile.cache_miss") == 0
    # every spelling of the membership view selects the same flags
    with mesh:
        want = eng._local_alive(Membership.all_alive(4).drop(1))
        assert torch.equal(want, torch.tensor([[1.0, 0.0], [1.0, 1.0]]))
        assert torch.equal(eng._local_alive([1, 0, 1, 1]), want)
        assert torch.equal(eng._local_alive(want), want)
        assert torch.equal(eng._local_alive(1.0), torch.ones(2, 2))
