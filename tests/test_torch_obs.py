"""repro_torch.obs (metrics, timeline, drift, report, the CLI) against the
JAX reference's (``tests/test_obs.py``).

The acceptance bar is the reference's: a recorded gradient sync on the
{pod: 2, data: 4} topology exports a Perfetto-loadable ``.trace.json``
whose wave structure matches the ExecutionPlan, the same exporter works
on a raw ``SwitchSim`` report, and the drift watchdog recommends a re-fit
on x2-perturbed link parameters while staying quiet on self-replay.  On
top, the port's Chrome trace JSON equals the reference's key for key for
the same recording, and its drift verdicts are the reference's.
"""

import collections
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro import obs as jobs
from repro import tune as jtune
from repro.cgra.simulate import SwitchSim as JSim
from repro.obs.drift import DriftWatchdog as JDriftWatchdog
from repro_torch import configs
from repro_torch import core as T
from repro_torch import obs, tree, tune
from repro_torch.cgra.simulate import SwitchSim
from repro_torch.core.types import TensorSpec
from repro_torch.mesh import LocalMesh
from repro_torch.models import Model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.drift import DriftWatchdog
from repro_torch.obs.report import RunReport
from repro_torch.obs.spans import StageSpan
from repro_torch.train import optimizer as topt
from repro_torch.train import step as S
from sim_parity import (assert_same_report, compile_pair,
                        with_port_placements)

AV = jax.ShapeDtypeStruct
N = 8
SIZES = {"data": 4, "pod": 2}


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_recorder_basics():
    rec = obs.Recorder()
    rec.count("a")
    rec.count("a", 2)
    rec.gauge("g", 7.5)
    rec.observe("h", 1.0)
    rec.observe("h", 3.0)
    rec.event("e", detail="x")
    assert rec.counter("a") == 3
    assert rec.counter("missing") == 0
    snap = rec.snapshot()
    assert snap["gauges"]["g"] == 7.5
    assert snap["hists"]["h"]["n"] == 2
    assert snap["hists"]["h"]["mean"] == 2.0
    assert snap["hists"]["h"]["min"] == 1.0
    assert snap["hists"]["h"]["max"] == 3.0
    assert snap["events"] == [{"name": "e", "detail": "x"}]
    assert json.loads(json.dumps(snap)) == snap      # JSON-able
    assert "a = 3" in rec.summary()
    rec.clear()
    assert rec.counter("a") == 0 and not rec.events


def test_recording_context_installs_and_restores():
    assert obs.current() is obs.null_recorder
    with obs.recording() as rec:
        assert obs.current() is rec
        assert rec.enabled
        obs_metrics.RECORDER.count("x")
        assert rec.counter("x") == 1
    assert obs.current() is obs.null_recorder


def test_null_recorder_noops():
    assert not obs.null_recorder.enabled
    obs.null_recorder.count("x")
    obs.null_recorder.observe("x", 1.0)
    obs.null_recorder.gauge("x", 1.0)
    obs.null_recorder.event("x")
    assert obs.null_recorder.counter("x") == 0
    assert not obs.null_recorder.events


def test_event_cap_never_grows_unbounded():
    rec = obs.Recorder()
    for _ in range(obs_metrics.MAX_EVENTS + 5):
        rec.event("e")
    assert len(rec.events) == obs_metrics.MAX_EVENTS
    assert rec.dropped_events == 5
    assert rec.snapshot()["dropped_events"] == 5


def test_package_exports_are_the_references():
    assert set(obs.__all__) == set(jobs.__all__)
    for name in ("DriftWatchdog", "DriftAlert", "DriftVerdict", "RunReport",
                 "chrome_trace", "timeline", "drift", "report"):
        assert getattr(obs, name) is not None


# ---------------------------------------------------------------------------
# shared stage-record schema
# ---------------------------------------------------------------------------

def test_stage_trace_is_stage_span():
    assert tune.StageTrace is StageSpan


def test_executor_instrument_emits_shared_spans():
    c = T.make_engine("acis").compile(
        lambda a, b: T.map(lambda x, y: x * y + 1.0, a, b, name="mul"),
        in_avals=(TensorSpec((256,), torch.float32),) * 2)
    with obs.recording() as rec:
        out, tr = tune.record_instrumented(
            c, torch.ones(256), torch.full((256,), 2.0))
    assert all(isinstance(s, StageSpan) for s in tr.stages)
    assert tr.stages[0].t_start == 0.0                 # normalized
    assert all(s.duration >= 0 for s in tr.stages)
    assert rec.counter("exec.instrumented_stages") == len(tr.stages)
    assert rec.hists["exec.stage_s"].n == len(tr.stages)
    assert torch.equal(out[0], torch.full((256,), 3.0))


# ---------------------------------------------------------------------------
# Perfetto export: acceptance on the {pod:2, data:4} gradient sync
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hier_run():
    """The engine's gradient-sync program on {data: 4, pod: 2}, recorded
    on both simulators (the reference with the port's placements)."""
    shapes = {"b": (7,), "w": (4, 33)}
    jeng = J.make_engine("acis_hierarchical", inner_axis="data",
                         outer_axis="pod")
    jleaves, jdef = jax.tree_util.tree_flatten(
        {k: AV(s, jnp.float32) for k, s in shapes.items()})
    jc = jeng._sync_program(jdef, tuple(jleaves), None, axis_sizes=SIZES)
    teng = T.make_engine("acis_hierarchical", inner_axis="data",
                         outer_axis="pod")
    tleaves, tdef = tree.tree_flatten(
        {k: torch.zeros(s) for k, s in shapes.items()})
    tc = teng._sync_program(
        tdef, tuple(TensorSpec(tuple(l.shape), l.dtype) for l in tleaves),
        None, axis_sizes=SIZES)
    rng = np.random.default_rng(0)
    # simulator leading dims follow topology order: inner (data=4) first
    xs = [rng.standard_normal((4, 2) + s).astype(np.float32)
          for _, s in sorted(shapes.items())]
    sim = SwitchSim(teng.topology(axis_size=SIZES))
    _, trace, report = tune.record_sim(
        tc, sim, *[torch.from_numpy(x) for x in xs])
    jref = with_port_placements(jc, tc)
    _, jtrace, jreport = jtune.record_sim(
        jref, JSim(jeng.topology(axis_size=SIZES)), *xs)
    assert_same_report(report, jreport)
    return teng, tc, trace, report, jref, jtrace, jreport


def _x_events(events):
    return [e for e in events if e["ph"] == "X" and e["name"] != "inject"]


def test_trace_records_match_the_reference(hier_run):
    _, _, trace, _, _, jtrace, _ = hier_run
    assert trace.stages == tuple(StageSpan(**dataclasses.asdict(s))
                                 for s in jtrace.stages)
    assert (trace.name, trace.axes, trace.t_end, trace.source) == \
        (jtrace.name, jtrace.axes, jtrace.t_end, jtrace.source)


def test_chrome_trace_json_equals_the_references(hier_run):
    _, tc, trace, report, jc, jtrace, jreport = hier_run
    for src, jsrc in ((trace, jtrace), (report, jreport)):
        got = json.loads(json.dumps(obs.chrome_trace(src, tc.plan)))
        want = json.loads(json.dumps(jobs.chrome_trace(jsrc, jc.plan)))
        assert got == want


def test_perfetto_schema_round_trip(hier_run, tmp_path):
    _, compiled, trace, _, _, _, _ = hier_run
    path = tmp_path / "sync.trace.json"
    obs.timeline.save(path, trace, compiled.plan)
    loaded = json.loads(path.read_text())

    events = loaded["traceEvents"]
    assert events, "empty trace"
    for e in events:
        assert e["ph"] in ("M", "X", "i")
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        if e["ph"] == "X":
            assert isinstance(e["ts"], float) and e["ts"] >= 0
            assert isinstance(e["dur"], float) and e["dur"] >= 0
        if e["ph"] == "i":
            assert e["s"] == "p"
    meta = {e["name"] for e in events if e["ph"] == "M"}
    assert {"process_name", "thread_name"} <= meta


def test_perfetto_wave_structure_matches_plan(hier_run):
    _, compiled, trace, _, _, _, _ = hier_run
    plan = compiled.plan
    tr = obs.chrome_trace(trace, plan)
    xs = _x_events(tr["traceEvents"])
    assert len(xs) == len(compiled.stages)
    wave_of = {i: w for w, grp in enumerate(plan.waves) for i in grp}
    for e in xs:
        assert e["args"]["wave"] == wave_of[e["args"]["stage"]]
    instants = [e for e in tr["traceEvents"] if e["ph"] == "i"]
    assert len(instants) == plan.n_waves
    starts = [e["ts"] for e in sorted(instants,
                                      key=lambda e: e["args"]["wave"])]
    assert starts == sorted(starts)
    assert all(e["tid"] >= 1 for e in xs)
    assert all(e["tid"] == 0 for e in instants)


def _nas_is():
    return compile_pair(lambda a: (lambda h, k: (a.reduce(h),
                                                 a.all_to_all(k))),
                        [(16,), (64,)], N)


def _nas_inputs(rng):
    return (rng.standard_normal((N, 16)).astype(np.float32),
            rng.standard_normal((N, 64)).astype(np.float32))


def test_exporter_parity_sim_report_vs_executor_schema(rng):
    """One exporter, two sources: the raw SwitchSim report and the
    shared-schema ProgramTrace built from it agree event for event."""
    c, _ = _nas_is()
    assert c.stage_kinds() == ["allreduce+alltoall"]
    h, k = _nas_inputs(rng)
    sim = SwitchSim(c.topology)
    _, trace, report = tune.record_sim(c, sim, torch.from_numpy(h),
                                       torch.from_numpy(k))
    ev_sim = obs.chrome_trace(report, c.plan)["traceEvents"]
    ev_exe = obs.chrome_trace(trace, c.plan)["traceEvents"]

    def key(e):
        return (e["name"], e["tid"], e["ts"], e["dur"], e["args"]["stage"],
                e["args"]["wave"])
    assert sorted(map(key, _x_events(ev_sim))) == \
        sorted(map(key, _x_events(ev_exe)))
    json.dumps(ev_sim), json.dumps(ev_exe)


def test_instrumented_timeline_uses_local_lane():
    c = T.make_engine("acis").compile(
        lambda a: T.map(lambda x: x + 1.0, a, name="inc"),
        in_avals=(TensorSpec((64,), torch.float32),))
    _, tr = tune.record_instrumented(c, torch.zeros(64))
    out = obs.chrome_trace(tr, c.plan)
    xs = _x_events(out["traceEvents"])
    assert xs and all("@" not in e["name"] for e in xs)
    lanes = {e["args"]["name"] for e in out["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "(local)" in lanes


# ---------------------------------------------------------------------------
# drift watchdog (verdicts held to the reference's on the same traces)
# ---------------------------------------------------------------------------

def _recorded(rng, perturb=False):
    """(port program, reference copy, port trace, reference trace)."""
    tc, jc = _nas_is()
    jc = with_port_placements(jc, tc)
    h, k = _nas_inputs(rng)
    tsim, jsim = SwitchSim(tc.topology), JSim(jc.topology)
    if perturb:
        for sim in (tsim, jsim):
            net = sim.nets["data"]
            sim.nets["data"] = dataclasses.replace(
                net, bw=net.bw * 0.5, fpga_link=net.fpga_link * 2.0)
    _, tr, _ = tune.record_sim(tc, tsim, torch.from_numpy(h),
                               torch.from_numpy(k))
    _, jtr, _ = jtune.record_sim(jc, jsim, h, k)
    return tc, jc, tr, jtr


def _same_verdicts(wd, jwd):
    assert wd.ratios() == jwd.ratios()
    assert [a.describe() for a in wd.alerts()] == \
        [a.describe() for a in jwd.alerts()]
    # the text names its own package's fit module
    assert wd.report().replace("repro_torch.", "repro.") == jwd.report()


def test_drift_quiet_on_self_replay(rng):
    tc, jc, trace, jtrace = _recorded(rng)
    wd, jwd = DriftWatchdog(), JDriftWatchdog()
    for _ in range(2):
        assert wd.observe(tc.plan, tc.topology, trace) == \
            jwd.observe(jc.plan, jc.topology, jtrace) > 0
    assert wd.alerts() == []
    _same_verdicts(wd, jwd)
    with obs.recording() as rec:
        assert not wd.refit_recommended()
    assert rec.counter("drift.flagged") == 0


def test_drift_fires_on_mismodeled_stage(rng):
    """A mis-modeled stage — measured durations x3 — is flagged with the
    pooled ratio near 3, as in the reference."""
    tc, jc, trace, jtrace = _recorded(rng)

    def slow(tr):
        return dataclasses.replace(tr, stages=tuple(
            dataclasses.replace(s, t_end=s.t_start + 3.0 * s.duration)
            for s in tr.stages))
    wd, jwd = DriftWatchdog(), JDriftWatchdog()
    with obs.recording() as rec:
        for _ in range(2):
            wd.observe(tc.plan, tc.topology, slow(trace))
            jwd.observe(jc.plan, jc.topology, slow(jtrace))
        assert wd.refit_recommended()
    _same_verdicts(wd, jwd)
    alerts = wd.alerts()
    assert alerts and alerts[0].ratio == pytest.approx(3.0, rel=0.35)
    assert alerts[0].drift > wd.threshold
    assert rec.counter("drift.flagged") >= 1
    assert any(n == "drift.refit_recommended" for n, _ in rec.events)
    assert "DRIFT" in wd.report()


def test_drift_recommends_refit_on_perturbed_links(rng):
    """x2-perturbed simulator link parameters drift every collective key
    past threshold, and the recommended re-fit runs — the port's fit is
    the reference's."""
    wd, jwd = DriftWatchdog(), JDriftWatchdog()
    for _ in range(2):
        tc, jc, tr, jtr = _recorded(rng, perturb=True)
        wd.observe(tc.plan, tc.topology, tr)
        jwd.observe(jc.plan, jc.topology, jtr)
    _same_verdicts(wd, jwd)
    assert wd.refit_recommended() and jwd.refit_recommended()
    fit, jfit = wd.refit(), jwd.refit()
    assert isinstance(fit, tune.NetFit)
    assert fit.n_stages == jfit.n_stages >= 1
    assert fit.tiers["ici"].bw == pytest.approx(jfit.tiers["ici"].bw,
                                                rel=1e-9)


def test_drift_rejects_bad_threshold():
    with pytest.raises(ValueError):
        DriftWatchdog(threshold=1.0)


# ---------------------------------------------------------------------------
# explain() symmetry + RunReport surfacing
# ---------------------------------------------------------------------------

def test_explain_without_recording_says_so(hier_run):
    compiled = hier_run[1]
    out = compiled.explain()
    assert "no recording attached" in out
    assert "meas_us" not in out.splitlines()[1]      # no phantom columns


def test_explain_accepts_run_report(hier_run):
    _, compiled, trace, _, _, _, _ = hier_run
    rep = RunReport(trace, compiled=compiled)
    from_report = compiled.explain(trace=rep)
    from_trace = compiled.explain(trace=trace)
    assert from_report == from_trace
    assert "mispredict ratio (meas/model)" in from_report
    assert "meas_us" in from_report


def test_run_report_text_json_save(hier_run, tmp_path):
    _, compiled, trace, _, _, _, _ = hier_run
    rec = obs.Recorder()
    rec.count("compile.programs")
    rep = RunReport.from_run(compiled, trace, recorder=rec)
    text = rep.text()
    assert "drift watchdog" in text and "counters:" in text
    payload = rep.to_json()
    assert payload["trace"]["stages"] == len(trace.stages)
    assert payload["program"]["waves"] == compiled.plan.n_waves
    assert "refit_recommended" in payload["drift"]
    assert payload["metrics"]["counters"]["compile.programs"] == 1
    json.dumps(payload)
    p = rep.save(tmp_path / "report.json")
    assert json.loads(open(p).read())["name"] == rep.name
    t = rep.save_trace(tmp_path / "run.trace.json")
    assert json.loads(open(t).read())["traceEvents"]


def test_obs_cli_report_and_trace(hier_run, tmp_path, capsys):
    """``python -m repro_torch.obs``: the port's CLI on the port's JSONL,
    and the reference's recording loads in the port (one schema)."""
    from repro_torch.obs.__main__ import main

    _, _, trace, _, _, jtrace, _ = hier_run
    src = tmp_path / "run.jsonl"
    tune.save_jsonl(src, trace)
    jsrc = tmp_path / "ref.jsonl"
    jtune.save_jsonl(jsrc, jtrace)
    assert src.read_text() == jsrc.read_text()

    out = tmp_path / "run.trace.json"
    assert main(["trace", str(src), "-o", str(out)]) == 0
    loaded = json.loads(out.read_text())
    assert len(_x_events(loaded["traceEvents"])) == len(trace.stages)

    assert main(["report", str(src), "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["trace"]["stages"] == len(trace.stages)

    assert main(["report", str(src)]) == 0
    assert "trace" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# counters threaded through compile / sim / serve
# ---------------------------------------------------------------------------

def test_compile_and_sim_counters(rng):
    with obs.recording() as rec:
        c = T.make_engine("acis").compile(
            lambda h, k: (T.reduce(h), T.all_to_all(k)),
            in_avals=(TensorSpec((16,), torch.float32),
                      TensorSpec((64,), torch.float32)), axis_size=N)
        sim = SwitchSim(c.topology)
        sim.run(c, *[torch.from_numpy(x) for x in _nas_inputs(rng)])
    assert rec.counter("compile.programs") >= 1
    assert rec.counter("emit.kernel_stage") \
        + rec.counter("emit.reference_stage") >= 1
    assert rec.counter("sim.runs") == 1
    assert rec.counter("sim.stages") == len(c.stages)
    assert rec.hists["plan.wave_width"].n == c.plan.n_waves
    assert rec.counter("cgra.placed") + rec.counter("cgra.host_fallback") \
        == len(c.stages)


def test_sync_cache_counters():
    eng = T.make_engine("acis")
    leaves, treedef = tree.tree_flatten({"w": torch.zeros(32)})
    avals = tuple(TensorSpec(tuple(l.shape), l.dtype) for l in leaves)
    with obs.recording() as rec:
        a = eng._sync_program(treedef, avals, None, axis_sizes={"data": N})
        b = eng._sync_program(treedef, avals, None, axis_sizes={"data": N})
    assert a is b
    assert rec.counter("compile.cache_miss") == 1
    assert rec.counter("compile.cache_hit") == 1


def test_serve_engine_counters():
    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.serve.engine import Request, ServeEngine

    model = Model(configs.get_smoke("rwkv6-1.6b"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rec = obs.Recorder()
    eng = ServeEngine(model, params, slots=2, max_seq=64, recorder=rec)
    eng.submit(Request(rid=0, prompt=np.arange(3, dtype=np.int32),
                       max_new_tokens=2))
    done = eng.run_to_completion()
    assert len(done) == 1
    assert rec.counter("serve.ticks") >= 1
    assert rec.counter("serve.admitted") == 1
    assert rec.counter("serve.retired") == 1
    assert rec.hists["serve.decode_s"].n >= 1
    assert rec.gauges["serve.active"] >= 0


# ---------------------------------------------------------------------------
# the span log (obs.spans.span): the train step and the sync, on the CPU
# ---------------------------------------------------------------------------

REMOVED = ("train.step_s", "coalesce.bucket_fill_frac", "plan.stage_bytes",
           "tune.fit_runs", "drift.observations", "drift.rank_observations")


def _smoke_step():
    """(step, state, batch, engine): a smoke acis-100m acis step on four
    CPU ranks, with the sync's arenas."""
    cfg = configs.get_smoke("acis-100m")
    mesh = LocalMesh({"data": 4}, device="cpu")
    eng = T.make_engine("acis")
    model, opt = Model(cfg), topt.adamw(1e-2)
    st = S.init_state(model, opt, torch.Generator().manual_seed(0), eng,
                      mesh=mesh, arenas=True)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (8, 9))
    return (S.build_train_step_acis(model, opt, mesh, eng), st,
            {"tokens": toks}, eng)


def test_spans_off_are_the_shared_noop(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    step, st, batch, _ = _smoke_step()
    assert obs.spans.span("train.step") is obs.spans.NOOP
    with obs.recording() as rec:
        assert obs.spans.span("train.step") is obs.spans.NOOP
        step(st, batch)
    assert rec.spans is None and rec.counter("train.steps") == 1


def test_spans_enter_record_function_only_under_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    step, st, batch, _ = _smoke_step()
    with obs.recording(spans=True) as rec:
        step(st, batch)
    assert [s.name for s in rec.spans][:2] == ["train.step",
                                               "train.forward"]


def test_train_step_spans_nest_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    step, st, batch, eng = _smoke_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            obs.recording(spans=True) as rec:
        for _ in range(2):
            st, _ = step(st, batch)
    log = rec.spans
    roots = [i for i, s in enumerate(log) if s.parent is None]
    assert [log[i].name for i in roots] == ["train.step"] * 2
    assert [log[i].id for i in roots] == [0, 1]
    prog = eng.last_sync_program()
    labels = sorted("stage." + s.label for s in prog.stages)
    for i in roots:
        kids = [j for j, s in enumerate(log) if s.parent == i]
        assert [log[j].name for j in kids] == [
            "train.forward", "train.backward", "train.sync", "train.update"]
        calls = [j for j, s in enumerate(log) if s.parent == kids[2]]
        assert [log[j].name for j in calls] == ["sync.call"]
        stages = [s.name for s in log if s.parent == calls[0]]
        assert sorted(stages) == labels and len(stages) == len(prog.stages)
        under = [s for s in log[i:] if s.id == log[i].id]
        assert len(under) == 6 + len(prog.stages)
    for s in log:
        assert s.t0_ns <= s.t1_ns and s.device_ms is None
        if s.parent is not None:
            p = log[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    assert rec.counter("train.steps") == 2
    for label, n in collections.Counter(s.label
                                        for s in prog.stages).items():
        assert rec.counter("sync.stages." + label) == 2 * n
    names = collections.Counter(e.name for e in prof.events())
    for name in ("train.step", "train.forward", "train.backward",
                 "train.sync", "train.update", "sync.call"):
        assert names["acis." + name] == 2
    assert sum(n for k, n in names.items()
               if k.startswith("acis.stage.")) == 2 * len(prog.stages)
    snap = rec.snapshot()
    assert len(snap["spans"]) == len(log) and json.dumps(snap)
    assert "span train.step: n=2" in rec.summary()


def test_sync_stage_labels_of_the_acis_and_int8_syncs():
    mesh = LocalMesh({"data": 8}, device="cpu")
    g = {f"l{i:02d}": torch.randn(8, 16 + i, dtype=torch.bfloat16
                                  if i % 3 else torch.float32)
         for i in range(33)}
    want = {
        ("acis",): {"allreduce": 2, "map.bucket_pack": 2,
                    "map.bucket_split": 33, "map.bucket_epilogue": 2},
        ("acis_compressed", "int8_hopquant"): {
            "ef_allreduce": 2, "map.bucket_pack": 2,
            "map.bucket_split": 66, "map.bucket_epilogue": 2,
            "map.ef_target": 33, "map.ef_residual": 33},
    }
    for (backend, *comp), labels in want.items():
        eng = T.make_engine(backend, **({"compressor": comp[0]}
                                        if comp else {}))
        res = eng.init_state(g) if comp else None
        with obs.recording(spans=True) as rec:
            eng.gradient_sync(g, res, mesh=mesh)
        got = collections.Counter(s.label
                                  for s in eng.last_sync_program().stages)
        assert got == labels
        assert {k[len("sync.stages."):]: v for k, v in rec.counters.items()
                if k.startswith("sync.stages.")} == labels
        assert collections.Counter(s.name for s in rec.spans) == \
            collections.Counter({"sync.call": 1, **{
                "stage." + k: v for k, v in labels.items()}})


def test_plain_recording_holds_no_spans_and_no_span_counters():
    step, st, batch, _ = _smoke_step()
    with obs.recording() as rec:
        step(st, batch)
    snap = rec.snapshot()
    assert rec.spans is None
    assert not {"spans", "dropped_spans"} & set(snap)
    assert not [k for k in snap["counters"]
                if k.startswith(("sync.stages.", "kernel."))]
    assert rec.counter("train.steps") == 1
    with pytest.raises(ValueError):
        with obs.recording(obs.Recorder(), spans=True):
            pass


def test_unread_telemetry_is_no_longer_emitted(rng):
    step, st, batch, _ = _smoke_step()
    with obs.recording() as rec:
        step(st, batch)
        wd = DriftWatchdog()
        for _ in range(2):
            tc, _, tr, _ = _recorded(rng, perturb=True)
            wd.observe(tc.plan, tc.topology, tr)
        wd.observe_ranks([1.0, 1.0, 2.0])
        assert isinstance(wd.refit(), tune.NetFit)
    assert rec.counter("compile.programs") >= 1
    assert rec.counter("train.steps") == 1
    assert not set(REMOVED) & (set(rec.counters) | set(rec.hists))


def test_span_log_cap_never_grows_unbounded():
    rec = obs.Recorder(spans=True)
    with obs.recording(rec):
        for _ in range(obs_metrics.MAX_EVENTS + 5):
            with obs.spans.span("x"):
                pass
    assert len(rec.spans) == obs_metrics.MAX_EVENTS
    assert rec.dropped_spans == 5
    assert rec.snapshot()["dropped_spans"] == 5
    assert [s.id for s in rec.spans[:3]] == [0, 1, 2]
