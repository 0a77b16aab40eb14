"""Perfetto wave timelines: spans → Chrome trace-event JSON.

One exporter for every recording the repo produces.  :func:`chrome_trace`
accepts anything with a ``stages`` sequence (or the bare sequence) whose
records are *span-shaped*:

  * :class:`repro_torch.obs.spans.StageSpan` — the shared stage-record schema
    the instrumented executor emits and ``tune.trace`` stores
    (``t_start``/``t_end``);
  * :class:`repro_torch.cgra.simulate.SimStage` — the dataplane simulator's
    per-stage report rows (``t_start``/``t_sim``; the injection-
    serialization share ``t_ser`` becomes a nested ``inject`` slice).

The emitted JSON is the Chrome trace-event format Perfetto (ui.perfetto.
dev) and ``chrome://tracing`` load directly: one thread lane (``tid``)
per mesh axis (axis-less local compute gets its own lane), every stage a
complete ``ph:"X"`` slice with microsecond ``ts``/``dur``, and every
ExecutionPlan wave boundary a ``ph:"i"`` instant event — overlapped
dispatch is *visible* as slices sharing a wall-clock interval on
different lanes, instead of inferred from medians.
"""

from __future__ import annotations

import json
from typing import Any, Optional, Sequence

US = 1e6                  # trace-event timestamps are in microseconds
LOCAL_LANE = "(local)"    # lane label for axis-less compute


def _span_bounds(s) -> tuple[float, float, Optional[float]]:
    """(t_start, t_end, t_ser) of one span-shaped record — StageSpan
    carries ``t_end``; a simulator ``SimStage`` carries ``t_sim``."""
    t0 = float(getattr(s, "t_start", 0.0))
    if hasattr(s, "t_end"):
        t1 = float(s.t_end)
    elif hasattr(s, "t_sim"):
        t1 = t0 + float(s.t_sim)
    else:
        raise TypeError(
            f"record {s!r} has neither t_end nor t_sim — not a stage span")
    return t0, t1, getattr(s, "t_ser", None)


def _stages_of(source) -> Sequence:
    stages = getattr(source, "stages", source)
    if not isinstance(stages, (list, tuple)):
        raise TypeError(f"cannot extract stage records from {source!r}")
    return stages


def lanes(source) -> dict[str, int]:
    """``{axis: tid}`` lane assignment, axes in first-use order (lane 1
    upward; tid 0 is reserved for the wave-boundary instants)."""
    out: dict[str, int] = {}
    for s in _stages_of(source):
        ax = getattr(s, "axis", "") or LOCAL_LANE
        if ax not in out:
            out[ax] = 1 + len(out)
    return out


def chrome_trace(source, plan=None, *, name: Optional[str] = None,
                 pid: int = 0) -> dict:
    """Chrome trace-event JSON (as a dict) for one recorded run.

    ``source`` is a :class:`~repro_torch.tune.trace.ProgramTrace`, a
    :class:`~repro_torch.cgra.simulate.SimReport`, an :class:`~repro_torch.obs.
    report.RunReport`, or a bare sequence of span-shaped records.
    ``plan`` (an :class:`~repro_torch.core.executor.ExecutionPlan`) is
    optional: when given, records missing a ``wave`` field inherit the
    plan's wave assignment and the instant events cover every plan wave
    (even ones the recording skipped).
    """
    source = getattr(source, "trace", source) \
        if not hasattr(source, "stages") and hasattr(source, "trace") \
        else source
    stages = _stages_of(source)
    lane_of = lanes(stages)
    label = name or getattr(source, "name", None) or "program"

    wave_of = {}
    if plan is not None:
        wave_of = {i: w for w, ws in enumerate(plan.waves) for i in ws}

    events: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": f"acis:{label}"}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
         "args": {"name": "waves"}},
    ]
    for ax, tid in lane_of.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid,
                       "args": {"name": ax if ax == LOCAL_LANE
                                else f"axis {ax}"}})

    wave_start: dict[int, float] = {}
    for idx, s in enumerate(stages):
        t0, t1, t_ser = _span_bounds(s)
        kind = getattr(s, "kind", "stage")
        ax = getattr(s, "axis", "") or LOCAL_LANE
        stage_i = getattr(s, "stage", idx)
        wave = getattr(s, "wave", None)
        if wave is None:
            wave = wave_of.get(stage_i, 0)
        wave_start[wave] = min(wave_start.get(wave, t0), t0)
        args: dict[str, Any] = {"stage": stage_i, "wave": wave}
        for f in ("schedule", "placement"):
            v = getattr(s, f, "")
            if v:
                # simulator rows carry the Placement object itself;
                # spans carry its describe() string — emit the string
                args[f] = v.describe() if hasattr(v, "describe") else v
        nbytes = getattr(s, "bytes", None)
        if nbytes is not None:
            args["bytes"] = int(nbytes)
        events.append({
            "ph": "X", "name": f"{kind}@{ax}" if ax != LOCAL_LANE
            else kind, "cat": kind, "pid": pid, "tid": lane_of[ax],
            "ts": t0 * US, "dur": max(t1 - t0, 0.0) * US, "args": args})
        if t_ser and 0.0 < t_ser <= (t1 - t0):
            # the injection-serialization share nests inside the stage
            # slice: the interval the shared port stays busy pushing
            # this stage's bytes (the part wave overlap cannot hide)
            events.append({
                "ph": "X", "name": "inject", "cat": "ser_hop",
                "pid": pid, "tid": lane_of[ax], "ts": t0 * US,
                "dur": float(t_ser) * US, "args": {"stage": stage_i}})

    if plan is not None:
        for w in range(plan.n_waves):
            wave_start.setdefault(w, max(wave_start.values(), default=0.0))
    for w in sorted(wave_start):
        events.append({
            "ph": "i", "name": f"wave {w}", "s": "p", "pid": pid,
            "tid": 0, "ts": wave_start[w] * US, "args": {"wave": w}})

    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"program": label,
                          "source": getattr(source, "source", "unknown")}}


def save(path, source, plan=None, *, name: Optional[str] = None) -> str:
    """Write ``source`` (or an already-built trace dict) as a
    ``.trace.json`` Perfetto loads; returns ``path``."""
    trace = source if isinstance(source, dict) and "traceEvents" in source \
        else chrome_trace(source, plan, name=name)
    with open(path, "w") as f:
        json.dump(trace, f, indent=1)
        f.write("\n")
    return str(path)
