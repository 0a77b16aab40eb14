"""Stage-trace recording: the observed side of the tuning loop.

A :class:`StageTrace` is one executed plan stage with wall-clock
boundaries — the shared currency of the whole ``repro_torch.tune`` subsystem,
and literally the same type as the observability layer's
:class:`repro_torch.obs.spans.StageSpan` (so recorded traces export straight
to Perfetto via :mod:`repro_torch.obs.timeline`).  Three recorders emit it:

  * :func:`from_sim` converts a dataplane-simulator
    :class:`~repro_torch.cgra.simulate.SimReport` (each ``SimStage`` already
    carries its branch start timestamp and injection-serialization
    share), so the record → fit → replay → search loop is testable
    without hardware;
  * :func:`record_instrumented` runs a rank-local
    :class:`~repro_torch.core.compiler.CompiledProgram` with the
    executor's instrumented mode (on the card a CUDA event pair per stage
    on the stream it runs on, one synchronize at the end — device time,
    stages keep their overlap; on the CPU ``perf_counter`` per stage);
  * :func:`record_stagewise` attributes per-stage time to a program run
    end to end by a caller's runner, by timing plan prefixes interleaved — the generalization of
    the A/B machinery in ``benchmarks/execplan.py`` (same idea: pair the
    variants inside one loop so clock drift cancels, take medians).

Traces serialize to JSONL (:func:`save_jsonl` / :func:`load_jsonl`):
one ``program`` header line followed by one line per stage, all stamped
with :data:`SCHEMA_VERSION` — a loader refuses records from a different
schema rather than silently misreading fields.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Optional, Sequence

from repro_torch.obs.spans import StageSpan

SCHEMA_VERSION = 1

# the stage record IS the obs layer's shared span schema — one type,
# emitted by the executor's instrument hook, stored by this module,
# exported by repro_torch.obs.timeline.  Kept under its historical name here.
StageTrace = StageSpan


@dataclasses.dataclass(frozen=True)
class ProgramTrace:
    """One recorded end-to-end run of a compiled program's plan."""

    name: str
    stages: tuple[StageTrace, ...]
    axes: dict
    t_end: float
    source: str = "unknown"        # "sim" | "instrumented" | "stagewise"
    schema: int = SCHEMA_VERSION

    @property
    def t_serial(self) -> float:
        """Sum of per-stage durations (the no-overlap cost)."""
        return sum(s.duration for s in self.stages)


# ---------------------------------------------------------------------------
# recorders
# ---------------------------------------------------------------------------

def _stage_meta(compiled, i: int) -> tuple[Optional[int], str]:
    st = compiled.stages[i]
    m = getattr(st.ir, "bytes_in", None) if st.ir is not None else None
    pl = st.placement.describe() if st.placement is not None else ""
    return m, pl


def from_sim(compiled, report) -> ProgramTrace:
    """A :class:`ProgramTrace` from a dataplane-simulator run.

    ``report.stages`` is in plan-stage order (every stage simulates), so
    row *i* pairs with ``compiled.stages[i]`` — the pairing that fills
    in the payload bytes and placement the replayer matches on.
    """
    if len(report.stages) != len(compiled.stages):
        raise ValueError(
            f"report has {len(report.stages)} stages, program has "
            f"{len(compiled.stages)} — not a run of this program")
    rows = []
    for i, s in enumerate(report.stages):
        m, pl = _stage_meta(compiled, i)
        rows.append(StageTrace(
            stage=i, kind=s.kind, axis=s.axis, wave=s.wave,
            t_start=s.t_start, t_end=s.t_start + s.t_sim, bytes=m,
            schedule=s.schedule, placement=pl, t_ser=s.t_ser))
    return ProgramTrace(
        name=getattr(compiled.source, "name", "program"),
        stages=tuple(rows), axes=dict(report.axes),
        t_end=report.t_end, source="sim")


def record_sim(compiled, sim, *inputs) -> tuple:
    """Run ``compiled`` on a :class:`~repro_torch.cgra.simulate.SwitchSim` and
    return ``(outputs, trace, report)``."""
    outs, report = sim.run(compiled, *inputs)
    return outs, from_sim(compiled, report), report


def record_instrumented(compiled, *xs, arenas=None,
                        axes: Optional[dict] = None) -> tuple:
    """Run a rank-local program eagerly with per-stage timing.

    Returns ``(outputs, trace)`` (outputs include the new arenas when
    ``arenas`` is passed, mirroring the program call).  Timestamps are
    normalized so the first stage starts at 0.  Run it inside ``with
    mesh:`` — see :func:`repro_torch.core.executor.execute` for which
    clock the spans carry (device time on CUDA values).
    """
    from repro_torch.obs import spans as _spans

    records: list[StageTrace] = []
    out = compiled(*xs, arenas=arenas, instrument=records)
    # the executor already emits the shared StageSpan schema (payload
    # bytes and placement attached) — just re-anchor t=0
    rows = _spans.normalize(records)
    t_end = max((s.t_end for s in rows), default=0.0)
    trace = ProgramTrace(
        name=getattr(compiled.source, "name", "program"),
        stages=tuple(rows), axes=dict(axes or {}), t_end=t_end,
        source="instrumented")
    return out, trace


def interleaved_medians(runs: dict[str, Callable[[], None]], *,
                        iters: int = 5, warmup: int = 1) -> dict[str, float]:
    """Median wall-clock of several zero-arg runners, timed interleaved.

    The generalized A/B machinery: iteration *k* runs every variant once
    before any variant runs iteration *k+1*, so slow clock drift and
    machine noise hit all variants alike and the medians stay
    comparable.  Returns ``{name: median_seconds}``.
    """
    import numpy as np

    for _ in range(max(warmup, 0)):
        for fn in runs.values():
            fn()
    samples: dict[str, list[float]] = {k: [] for k in runs}
    for _ in range(max(iters, 1)):
        for k, fn in runs.items():
            t0 = time.perf_counter()
            fn()
            samples[k].append(time.perf_counter() - t0)
    return {k: float(np.median(v)) for k, v in samples.items()}


def _prefix_plan(plan, k: int):
    """The plan truncated to its first ``k`` stages, every produced value
    an output (nothing is left unused)."""
    from repro_torch.core import executor

    stages = tuple(plan.stages[:k])
    outs = tuple(v for st in stages for v in st.out_vids)
    return executor.build_plan(stages, plan.num_inputs, outs)


def record_stagewise(compiled, runner_factory: Callable, *,
                     iters: int = 5,
                     axes: Optional[dict] = None) -> ProgramTrace:
    """Per-stage wall-clock for a program via prefix timing.

    ``runner_factory(prefix_plan)`` must return a zero-arg callable that
    executes the prefix plan end to end (typically
    :func:`~repro_torch.core.executor.execute` inside the caller's mesh,
    synchronizing the device on the result).  The k-stage prefix
    is timed against the (k-1)-stage prefix interleaved; the difference
    is attributed to stage k-1.  Costs n_stages compiles — a profiling
    tool, not a fast path.
    """
    plan = compiled.plan
    n = len(plan.stages)
    runs = {str(k): runner_factory(_prefix_plan(plan, k))
            for k in range(n + 1)}
    meds = interleaved_medians(runs, iters=iters)
    wave_of = {i: w for w, ws in enumerate(plan.waves) for i in ws}
    rows, t = [], 0.0
    for i in range(n):
        st = plan.stages[i]
        dt = max(meds[str(i + 1)] - meds[str(i)], 0.0)
        m, pl = _stage_meta(compiled, i)
        rows.append(StageTrace(
            stage=i, kind=st.kind, axis=st.axis, wave=wave_of.get(i, 0),
            t_start=t, t_end=t + dt, bytes=m, schedule=st.schedule,
            placement=pl))
        t += dt
    return ProgramTrace(
        name=getattr(compiled.source, "name", "program"),
        stages=tuple(rows), axes=dict(axes or {}), t_end=t,
        source="stagewise")


# ---------------------------------------------------------------------------
# JSONL persistence
# ---------------------------------------------------------------------------

def save_jsonl(path, traces: Sequence[ProgramTrace] | ProgramTrace) -> None:
    """Write traces as JSONL: per trace one ``program`` header line, then
    one ``stage`` line per stage, all carrying the schema version."""
    if isinstance(traces, ProgramTrace):
        traces = [traces]
    with open(path, "w") as f:
        for tr in traces:
            f.write(json.dumps({
                "record": "program", "schema": tr.schema, "name": tr.name,
                "axes": {k: int(v) for k, v in tr.axes.items()},
                "t_end": tr.t_end, "source": tr.source}) + "\n")
            for s in tr.stages:
                f.write(json.dumps(
                    {"record": "stage", **dataclasses.asdict(s)}) + "\n")


def load_jsonl(path) -> list[ProgramTrace]:
    """Load every trace from a JSONL file written by :func:`save_jsonl`.

    Refuses records whose ``schema`` differs from
    :data:`SCHEMA_VERSION` — the on-disk format is versioned precisely
    so a replayer never misreads fields recorded by a different build.
    """
    traces: list[ProgramTrace] = []
    header: Optional[dict] = None
    stages: list[StageTrace] = []

    def flush():
        if header is not None:
            traces.append(ProgramTrace(
                name=header["name"], stages=tuple(stages),
                axes=dict(header.get("axes", {})),
                t_end=float(header["t_end"]),
                source=header.get("source", "unknown")))

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.pop("record", None)
            if kind == "program":
                if rec.get("schema") != SCHEMA_VERSION:
                    raise ValueError(
                        f"trace schema {rec.get('schema')!r} != "
                        f"{SCHEMA_VERSION} — re-record with this build")
                flush()
                header, stages = rec, []
            elif kind == "stage":
                if header is None:
                    raise ValueError("stage record before program header")
                stages.append(StageTrace(**rec))
            else:
                raise ValueError(f"unknown record type {kind!r}")
    flush()
    return traces
