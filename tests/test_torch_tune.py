"""repro_torch.tune (trace, fit, replay, search, the tuning DB) and the
engine's ``autotune`` against the JAX reference's (``tests/test_tune.py``).

The loop runs against the dataplane simulators, as in the reference:
record → fit → replay → search without hardware.  Every case the
reference pins is pinned here on the port, and the port is held to the
reference on the same simulated traces: the same stage records, a
``NetFit`` within 1e-9 relative, the same replayed times and the same
search winner.  Every ``TuneDB`` lives in ``tmp_path``.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.tune as jtune
import repro_torch.tune as tune
from repro import core as J
from repro.cgra.simulate import SwitchSim as JSim
from repro.core import netmodel as jnetmodel
from repro_torch import core as T
from repro_torch import tree
from repro_torch.cgra.device import HostFallback
from repro_torch.cgra.simulate import SwitchSim
from repro_torch.core import ADD, netmodel, tracing
from repro_torch.core.types import TensorSpec
from repro_torch.mesh import LocalMesh
from sim_parity import assert_same_report, with_port_placements

search_mod = importlib.import_module("repro_torch.tune.search")

AV = jax.ShapeDtypeStruct


def _sync_program(sizes, engine, axis_sizes, a=T):
    """Mean-sync over a flat list of f32 leaves, built in package ``a``
    (``T`` the port, ``J`` the reference) by its ``engine``."""
    n_total = 1
    for v in axis_sizes.values():
        n_total *= v

    def _mean(y):
        return y / n_total

    def sync(*gs):
        return tuple(
            a.map(_mean, a.reduce(g, axis="auto"), name="mean",
                  elementwise=True) for g in gs)

    prog = a.trace(sync, name=f"sync[{len(sizes)}]", num_inputs=len(sizes))
    if a is T:
        avals = tuple(TensorSpec((s,), torch.float32) for s in sizes)
    else:
        avals = tuple(AV((s,), jnp.float32) for s in sizes)
    return engine.compile(prog, in_avals=avals, axis_size=axis_sizes)


def _pair(sizes, axis_sizes, **cfg):
    tc = _sync_program(sizes, T.make_engine("acis", **cfg), axis_sizes)
    jc = _sync_program(sizes, J.make_engine("acis", **cfg), axis_sizes, J)
    return tc, with_port_placements(jc, tc)


def _record_pair(tc, jc, sizes, data, *, perturb=None):
    """One seeded input through both simulators: (port trace, reference
    trace, port report)."""
    rng = np.random.default_rng(0)
    ins = [rng.standard_normal((data, s)).astype(np.float32) for s in sizes]
    tsim, jsim = SwitchSim(tc.topology), JSim(jc.topology)
    if perturb is not None:
        for sim in (tsim, jsim):
            sim.nets["data"] = dataclasses.replace(
                sim.nets["data"], **perturb(sim.nets["data"]))
    _, trace, report = tune.record_sim(
        tc, tsim, *[torch.from_numpy(x) for x in ins])
    _, jtrace, jreport = jtune.record_sim(jc, jsim, *ins)
    assert_same_report(report, jreport)
    return trace, jtrace, report


def _same_fit(fit, jfit):
    assert fit.dropped == jfit.dropped and fit.n_stages == jfit.n_stages
    for t in jfit.tiers:
        for f in ("bw", "fpga_link", "mpi_overhead", "host_bw", "port"):
            assert getattr(fit.tiers[t], f) == pytest.approx(
                getattr(jfit.tiers[t], f), rel=1e-9, abs=0.0)
    assert fit.detour == pytest.approx(jfit.detour, rel=1e-9)
    assert fit.host_bw == pytest.approx(jfit.host_bw, rel=1e-9)
    assert fit.residual == pytest.approx(jfit.residual, rel=1e-9, abs=1e-15)
    assert set(fit.overlap) == set(jfit.overlap)
    for k in jfit.overlap:
        assert fit.overlap[k] == pytest.approx(jfit.overlap[k], rel=1e-9)


# ---------------------------------------------------------------------------
# StageTerms ≡ stage_time (the port's netmodel against the reference's)
# ---------------------------------------------------------------------------

class TestStageTerms:
    KINDS = ["allreduce", "reduce_scatter", "allgather", "alltoall",
             "bcast", "scan", "scan+allgather", "ef_allreduce",
             "allreduce+alltoall"]

    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("n", [1, 2, 4, 8])
    @pytest.mark.parametrize("m", [256, 1 << 16])
    def test_matches_stage_time(self, kind, n, m):
        p = netmodel.PAPER
        for schedule in ("", "latency", "bandwidth"):
            t_ref = netmodel.stage_time(kind, n, m, p, schedule=schedule)
            assert t_ref == jnetmodel.stage_time(kind, n, m,
                                                 jnetmodel.PAPER,
                                                 schedule=schedule)
            terms = netmodel.stage_time_terms(kind, n, m,
                                              schedule=schedule)
            assert terms is not None
            assert terms.time(p) == pytest.approx(t_ref, rel=1e-12)

    @pytest.mark.parametrize("kind", ["map", "allreduce",
                                      "reduce_scatter", "scan",
                                      "ef_allreduce",
                                      "allreduce+alltoall"])
    def test_matches_fallback_branch(self, kind):
        p = netmodel.PAPER
        hf = HostFallback("test")
        n, m = 4, 1 << 15
        t_ref = netmodel.stage_time(kind, n, m, p, placement=hf)
        terms = netmodel.stage_time_terms(kind, n, m, fallback=True)
        assert terms.time(p) == pytest.approx(t_ref, rel=1e-12)

    def test_codec_ratio_scales_wire(self):
        p = netmodel.PAPER
        t_ref = netmodel.stage_time("allreduce", 8, 1 << 20, p,
                                    codec_ratio=0.25)
        terms = netmodel.stage_time_terms("allreduce", 8, 1 << 20,
                                          codec_ratio=0.25)
        assert terms.time(p) == pytest.approx(t_ref, rel=1e-12)

    def test_plan_stage_terms_matches_plan_stage_time(self):
        c = _sync_program([4096, 131072, 300, 65536], T.make_engine("acis"),
                          {"data": 4})
        priced = 0
        for st in c.stages:
            got = netmodel.plan_stage_terms(st, c.topology)
            if got is None:
                continue
            tier, terms, placement = got
            net = c.topology.net(st.axis) if st.axis else netmodel.PAPER
            t_ref = netmodel.plan_stage_time(st, c.topology, netmodel.PAPER)
            assert terms.time(net, placement) == pytest.approx(
                t_ref, rel=1e-12)
            priced += 1
        assert priced > 0


# ---------------------------------------------------------------------------
# trace recording + JSONL round trip
# ---------------------------------------------------------------------------

SIZES3 = [4096, 131072, 65536]


class TestTrace:
    def test_sim_trace_shape(self):
        tc, jc = _pair(SIZES3, {"data": 4})
        trace, jtrace, report = _record_pair(tc, jc, SIZES3, 4)
        assert len(trace.stages) == len(tc.stages)
        assert trace.source == "sim"
        assert trace.t_end == report.t_end
        for ts in trace.stages:
            assert ts.t_end >= ts.t_start >= 0.0
            assert ts.kind == tc.stages[ts.stage].kind
        assert [dataclasses.asdict(s) for s in trace.stages] == \
            [dataclasses.asdict(s) for s in jtrace.stages]
        assert (trace.name, trace.axes, trace.t_end) == \
            (jtrace.name, jtrace.axes, jtrace.t_end)

    def test_jsonl_round_trip(self, tmp_path):
        """The same schema and JSON keys as the reference: each package
        writes the same file, and each reads the other's."""
        tc, jc = _pair(SIZES3, {"data": 4})
        trace, jtrace, _ = _record_pair(tc, jc, SIZES3, 4)
        path, jpath = tmp_path / "trace.jsonl", tmp_path / "ref.jsonl"
        tune.save_jsonl(path, trace)
        jtune.save_jsonl(jpath, jtrace)
        assert path.read_text() == jpath.read_text()
        assert tune.SCHEMA_VERSION == jtune.SCHEMA_VERSION
        back = tune.load_jsonl(jpath)
        assert len(back) == 1
        assert back[0].stages == trace.stages
        assert back[0].t_end == trace.t_end
        assert back[0].axes == trace.axes
        assert [dataclasses.asdict(s) for s in jtune.load_jsonl(path)[0]
                .stages] == [dataclasses.asdict(s) for s in trace.stages]

    def test_loader_rejects_other_schema(self, tmp_path):
        path = tmp_path / "bad.jsonl"
        path.write_text(
            '{"record": "program", "schema": 999, "name": "x", '
            '"axes": {}, "t_end": 0.0, "source": "sim"}\n')
        with pytest.raises(ValueError, match="schema"):
            tune.load_jsonl(path)

    def test_loader_rejects_headerless_stage(self, tmp_path):
        path = tmp_path / "bad.jsonl"
        path.write_text('{"record": "stage", "stage": 0, "kind": "map"}\n')
        with pytest.raises(ValueError, match="header"):
            tune.load_jsonl(path)

    def test_instrumented_eager_map_program(self):
        """The executor's instrument hook: an axis-less program records
        one StageTrace per stage with host timestamps (CPU values)."""
        def prog(x, y):
            a = tracing.map(lambda v: v * 2.0, x, name="double")
            return (tracing.map(torch.add, a, y, name="add"),)

        c = T.make_engine("acis").compile(
            prog, in_avals=(TensorSpec((1024,), torch.float32),) * 2)
        out, trace = tune.record_instrumented(c, torch.ones(1024),
                                              torch.ones(1024))
        assert trace.source == "instrumented"
        assert len(trace.stages) == len(c.stages)
        assert trace.t_end > 0.0
        assert all(s.t_end >= s.t_start for s in trace.stages)
        assert torch.equal(out[0], torch.full((1024,), 3.0))

    def test_instrumented_ring_program_inside_a_mesh(self):
        """A ring sync recorded inside ``with mesh:`` — spans in plan
        dispatch order, the stages' metadata attached."""
        c = _sync_program([300, 5000], T.make_engine("acis"), {"data": 4})
        xs = [torch.randn(4, s) for s in (300, 5000)]
        with LocalMesh({"data": 4}, device="cpu"):
            out, trace = tune.record_instrumented(c, *xs, axes={"data": 4})
        assert sorted(s.stage for s in trace.stages) == \
            list(range(len(c.stages)))
        assert trace.axes == {"data": 4}
        for s in trace.stages:
            assert s.kind == c.stages[s.stage].kind
        torch.testing.assert_close(out[1][0], xs[1].mean(0))


# ---------------------------------------------------------------------------
# replay: the two fixed points + determinism
# ---------------------------------------------------------------------------

class TestReplay:
    def _recorded(self):
        tc, jc = _pair(SIZES3, {"data": 4})
        trace, jtrace, report = _record_pair(tc, jc, SIZES3, 4)
        return tc, jc, trace, jtrace, report

    def test_empty_trace_is_program_time(self):
        tc, jc, _, _, _ = self._recorded()
        r = tune.replay(tc.plan, None, tc.topology)
        assert r.matched == 0
        assert r.t_end == pytest.approx(
            netmodel.program_time(tc.plan, tc.topology), rel=1e-12)
        assert r.t_end == jtune.replay(jc.plan, None, jc.topology).t_end

    def test_self_replay_reproduces_recording(self):
        tc, jc, trace, jtrace, report = self._recorded()
        r = tune.replay(tc.plan, trace, tc.topology)
        assert r.match_fraction == 1.0
        assert abs(r.t_end - report.t_end) <= 0.05 * report.t_end
        jr = jtune.replay(jc.plan, jtrace, jc.topology)
        assert (r.t_end, r.matched, r.modeled) == \
            (jr.t_end, jr.matched, jr.modeled)
        assert [dataclasses.astuple(s) for s in r.stages] == \
            [dataclasses.astuple(s) for s in jr.stages]

    def test_deterministic(self):
        tc, _, trace, _, _ = self._recorded()
        r1 = tune.replay(tc.plan, trace, tc.topology)
        r2 = tune.replay(tc.plan, trace, tc.topology)
        assert r1.t_end == r2.t_end
        assert r1.stages == r2.stages

    def test_serial_mode_sums_chains(self):
        tc, jc, trace, jtrace, _ = self._recorded()
        r_ov = tune.replay(tc.plan, trace, tc.topology, overlapped=True)
        r_ser = tune.replay(tc.plan, trace, tc.topology, overlapped=False)
        assert r_ser.t_end >= r_ov.t_end
        assert r_ser.t_end == jtune.replay(jc.plan, jtrace, jc.topology,
                                           overlapped=False).t_end

    def test_mismatched_stages_fall_back_to_model(self):
        """A candidate plan the recording doesn't cover scores on the
        analytic model — replay stays defined across plan changes."""
        tc, jc, trace, jtrace, _ = self._recorded()
        tc2, jc2 = _pair(SIZES3, {"data": 4}, bucket_bytes=0)
        r = tune.replay(tc2.plan, trace, tc2.topology)
        assert r.modeled > 0
        assert r.t_end > 0.0
        jr = jtune.replay(jc2.plan, jtrace, jc2.topology)
        assert (r.t_end, r.matched, r.modeled) == \
            (jr.t_end, jr.matched, jr.modeled)


# ---------------------------------------------------------------------------
# fit: NetParams recovery from simulated traces
# ---------------------------------------------------------------------------

def _perturb(net):
    return {"bw": net.bw * 0.5, "fpga_link": net.fpga_link * 2.0}


class TestFit:
    SIZES = [4096, 65536, 131072, 524288, 8192, 262144]

    def _perturbed_samples(self):
        """Per-leaf sync (diverse payloads → hop and 1/bw columns
        separate) simulated under perturbed ici link parameters, in both
        packages."""
        tc, jc = _pair(self.SIZES, {"data": 4}, bucket_bytes=0)
        trace, jtrace, _ = _record_pair(tc, jc, self.SIZES, 4,
                                        perturb=_perturb)
        true = dataclasses.replace(
            tc.topology.net("data"), **_perturb(tc.topology.net("data")))
        return [(tc.plan, tc.topology, trace)], \
            [(jc.plan, jc.topology, jtrace)], true

    def test_recovers_perturbed_link_params(self):
        samples, jsamples, true = self._perturbed_samples()
        fit = tune.fit_net_params(samples, tiers=("ici",))
        got = fit.tiers["ici"]
        assert got.bw == pytest.approx(true.bw, rel=0.05)
        assert got.fpga_link == pytest.approx(true.fpga_link, rel=0.05)
        assert fit.residual < 1e-6
        _same_fit(fit, jtune.fit_net_params(jsamples, tiers=("ici",)))

    def test_unobserved_tier_drops_to_prior(self):
        samples, jsamples, _ = self._perturbed_samples()
        fit = tune.fit_net_params(samples, tiers=("ici", "dci"))
        assert "dci.hop" in fit.dropped
        assert "dci.invbw" in fit.dropped
        assert fit.tiers["dci"].bw == netmodel.TIERS["dci"].bw
        _same_fit(fit, jtune.fit_net_params(jsamples, tiers=("ici", "dci")))

    def test_collinear_columns_drop_and_resolve(self):
        sizes = [65536, 65536, 65536]
        tc, jc = _pair(sizes, {"data": 4}, bucket_bytes=0)
        trace, jtrace, _ = _record_pair(tc, jc, sizes, 4)
        fit = tune.fit_net_params([(tc.plan, tc.topology, trace)],
                                  tiers=("ici",))
        assert "ici.hop" in fit.dropped or "ici.invbw" in fit.dropped
        assert fit.residual < 1e-6
        _same_fit(fit, jtune.fit_net_params(
            [(jc.plan, jc.topology, jtrace)], tiers=("ici",)))

    def test_fit_traces_overlap_special_case(self):
        tc, jc = _pair(SIZES3, {"data": 4})
        trace, jtrace, _ = _record_pair(tc, jc, SIZES3, 4)
        fit = tune.fit_traces([(tc.plan, tc.topology, trace)],
                              tiers=("ici",))
        assert set(fit.overlap) >= {"ici", "dci", "local"}
        prior = netmodel.TIERS["ici"]
        assert fit.tiers["ici"].bw == pytest.approx(prior.bw, rel=0.05)
        _same_fit(fit, jtune.fit_traces([(jc.plan, jc.topology, jtrace)],
                                        tiers=("ici",)))

    def test_fitted_params_flow_into_replay(self):
        samples, jsamples, _ = self._perturbed_samples()
        fit = tune.fit_net_params(samples, tiers=("ici",))
        plan, topo, _ = samples[0]
        r_prior = tune.replay(plan, None, topo)
        r_fit = tune.replay(plan, None, topo, fit=fit)
        assert r_fit.t_end > r_prior.t_end
        jfit = jtune.fit_net_params(jsamples, tiers=("ici",))
        jplan, jtopo, _ = jsamples[0]
        assert r_fit.t_end == pytest.approx(
            jtune.replay(jplan, None, jtopo, fit=jfit).t_end, rel=1e-9)


# ---------------------------------------------------------------------------
# search + tuning DB
# ---------------------------------------------------------------------------

def _tail_sizes(n=64):
    rng = np.random.default_rng(7)
    return [int(rng.integers(1 << 8, 1 << 13)) for _ in range(n)]


def _build_fn(sizes, axis_sizes, a=T):
    def build(cfg):
        eng = a.make_engine("acis")
        eng.config = cfg
        return _sync_program(sizes, eng, axis_sizes, a)
    return build


class TestSearch:
    def test_search_beats_default_on_ragged_tail(self):
        """The searched config's analytic program_time beats the default
        bucket_bytes config on the 64-leaf ragged sync, and the winner is
        the reference's."""
        base = T.make_engine("acis").config
        build = _build_fn(_tail_sizes(), {"data": 8})
        res = tune.search(build, base=base)
        assert res.overrides, "search found nothing to change"
        assert res.score < res.default_score
        tuned = build(dataclasses.replace(base, **res.overrides))
        default = build(base)
        assert tuned.program_time() < default.program_time()
        jres = jtune.search(_build_fn(_tail_sizes(), {"data": 8}, J),
                            base=dataclasses.replace(
                                J.make_engine("acis").config,
                                use_kernels=base.use_kernels))
        assert res.overrides == jres.overrides
        assert res.score == pytest.approx(jres.score, rel=1e-12)
        assert res.n_evals == jres.n_evals

    def test_search_is_deterministic(self):
        base = T.make_engine("acis").config
        build = _build_fn(_tail_sizes(8), {"data": 4})
        r1 = tune.search(build, base=base)
        r2 = tune.search(build, base=base)
        assert r1.overrides == r2.overrides
        assert r1.score == r2.score

    def test_tunedb_round_trip(self, tmp_path):
        db = tune.TuneDB(str(tmp_path / "db.json"))
        db.store("k1", {"bucket_bytes": 0}, score=1.0)
        assert db.lookup("k1")["overrides"] == {"bucket_bytes": 0}
        db2 = tune.TuneDB(str(tmp_path / "db.json"))
        assert db2.lookup("k1")["overrides"] == {"bucket_bytes": 0}
        assert db2.lookup("nope") is None

    def test_tunedb_ignores_foreign_schema(self, tmp_path):
        path = tmp_path / "db.json"
        path.write_text('{"schema": 999, "entries": {"k": {}}}')
        assert tune.TuneDB(str(path)).lookup("k") is None

    def test_default_db_is_the_ports_own(self, monkeypatch):
        """The port's default DB file is not the reference's: a plan tuned
        on the card is never read back by the reference, nor the other
        way round."""
        monkeypatch.delenv(search_mod.DB_ENV_VAR, raising=False)
        assert tune.TuneDB().path == ".acis_tune_torch.json"
        assert tune.TuneDB().path != jtune.TuneDB().path
        monkeypatch.setenv(search_mod.DB_ENV_VAR, "/elsewhere.json")
        assert tune.TuneDB().path == "/elsewhere.json"

    def test_autotune_hits_db_without_research(self, tmp_path):
        """The second engine compile of the same (pytree, topology) with
        autotune on hits the DB — no second search."""
        db = str(tmp_path / "tune.json")
        sizes = _tail_sizes(16)
        avals = tuple(TensorSpec((s,), torch.float32) for s in sizes)
        _, treedef = tree.tree_flatten([0] * len(sizes))

        n0 = search_mod.SEARCHES_RUN
        e1 = T.make_engine("acis", autotune=True, tune_db=db)
        c1 = e1._sync_program(treedef, avals, None, axis_sizes={"data": 8})
        assert search_mod.SEARCHES_RUN == n0 + 1
        e2 = T.make_engine("acis", autotune=True, tune_db=db)
        c2 = e2._sync_program(treedef, avals, None, axis_sizes={"data": 8})
        assert search_mod.SEARCHES_RUN == n0 + 1, "DB hit re-searched"
        assert [s.kind for s in c2.stages] == [s.kind for s in c1.stages]
        e3 = T.make_engine("acis")
        c3 = e3._sync_program(treedef, avals, None, axis_sizes={"data": 8})
        assert c1.program_time() < c3.program_time()
        # the reference's engine tunes the same structure to the same plan
        jdef = jax.tree_util.tree_structure([0] * len(sizes))
        jc1 = J.make_engine("acis", autotune=True,
                            tune_db=str(tmp_path / "ref.json"))._sync_program(
            jdef, tuple(AV((s,), jnp.float32) for s in sizes), None,
            axis_sizes={"data": 8})
        assert c1.stage_kinds() == jc1.stage_kinds()
        assert c1.program_time() == pytest.approx(jc1.program_time(),
                                                  rel=1e-9)

    def test_autotuned_sync_matches_default_numerics(self, tmp_path):
        """gradient_sync under autotune returns the same mean as the
        untuned path — tuning changes the plan, not the math."""
        sizes = _tail_sizes(8)
        rng = np.random.default_rng(3)
        grads = [torch.from_numpy(rng.standard_normal((8, s))
                                  .astype(np.float32)) for s in sizes]
        mesh = LocalMesh({"data": 8}, device="cpu")
        want, _ = T.make_engine("acis").gradient_sync(grads, None,
                                                      mesh=mesh)
        got, _ = T.make_engine("acis", autotune=True,
                               tune_db=str(tmp_path / "t.json")) \
            .gradient_sync(grads, None, mesh=mesh)
        for w, g in zip(want, got):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)

    def test_autotune_compile_star_args_program(self, tmp_path):
        """engine.compile with autotune on handles ``*args`` programs: the
        arity comes from in_avals, traced once, not per candidate."""
        eng = T.make_engine("acis", autotune=True,
                            tune_db=str(tmp_path / "tune.json"))
        sizes = _tail_sizes(6)
        c = eng.compile(
            lambda *vs: tuple(tracing.reduce(v, ADD, axis="data")
                              for v in vs),
            in_avals=tuple(TensorSpec((s,), torch.float32) for s in sizes),
            axis_size={"data": 8})
        assert len(c.plan.stages) > 0
        xs = [torch.ones((8, s)) for s in sizes]
        outs, _ = SwitchSim(c.topology).run(c, *xs)
        for s, o in zip(sizes, outs):
            assert torch.equal(o[0], torch.full((s,), 8.0))

    def test_sync_cache_keys_on_config_fields(self):
        """The same engine re-pointed at a config differing only in tuned
        fields must not return the stale program."""
        sizes = [4096, 131072, 65536, 8192]
        avals = tuple(TensorSpec((s,), torch.float32) for s in sizes)
        _, treedef = tree.tree_flatten([0] * len(sizes))
        eng = T.make_engine("acis")
        c1 = eng._sync_program(treedef, avals, None, axis_sizes={"data": 4})
        eng.config = dataclasses.replace(eng.config, bucket_bytes=0)
        c2 = eng._sync_program(treedef, avals, None, axis_sizes={"data": 4})
        assert len(c2.stages) != len(c1.stages)
        assert "autotune" not in repr(eng.config.cache_key())

    def test_arena_cache_keys_on_program(self):
        """Arenas are keyed by the compiled program: per-leaf and
        bucketized configs over one pytree get distinct (here: absent vs
        present) arena sets."""
        sizes = _tail_sizes(16)
        mesh = LocalMesh({"data": 4}, device="cpu")
        grads = [torch.zeros(4, s) for s in sizes]
        a1 = T.make_engine("acis").init_arenas(grads, mesh=mesh)
        a2 = T.make_engine("acis", bucket_bytes=0).init_arenas(grads,
                                                               mesh=mesh)
        assert a1 is not None
        assert a2 is None  # per-leaf sync has no bucket packs


# ---------------------------------------------------------------------------
# explain(trace=...)
# ---------------------------------------------------------------------------

class TestExplainTrace:
    def test_measured_vs_model_columns(self):
        tc, jc = _pair(SIZES3, {"data": 4})
        trace, jtrace, _ = _record_pair(tc, jc, SIZES3, 4)
        text = tc.explain(trace)
        assert "meas_us" in text
        assert "model_us" in text
        assert "mispredict ratio" in text
        assert "meas_us" not in tc.explain()
        # the same measured/model columns as the reference
        mine = [ln.split()[-3:] for ln in text.splitlines()[3:-1]]
        ref = [ln.split()[-3:] for ln in jc.explain(jtrace).splitlines()[3:-1]]
        assert mine == ref


@pytest.mark.cuda
def test_instrumented_spans_carry_device_time_on_the_card():
    """On CUDA values each span comes from a CUDA event pair on the stage's
    stream, read after one synchronize: ordered, non-negative, and the
    first stage starts at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = _sync_program([300, 5000], T.make_engine("acis"), {"data": 4})
    xs = [torch.randn(4, s, device="cuda") for s in (300, 5000)]
    with LocalMesh({"data": 4}, device="cuda"):
        out, trace = tune.record_instrumented(c, *xs)
    assert trace.stages[0].t_start == 0.0
    assert all(s.t_end >= s.t_start >= 0.0 for s in trace.stages)
    assert trace.t_end > 0.0
    torch.testing.assert_close(out[1][0], xs[1].mean(0))
