"""RunReport — one recorded run, aggregated (text + JSON + timeline).

The surfacing layer over the other three obs pieces: a
:class:`RunReport` holds a recorded trace, the metrics snapshot of the
run, and the drift watchdog's verdict, renders them as text
(:meth:`RunReport.text`) or JSON (:meth:`RunReport.to_json`), and dumps
the Perfetto timeline (:meth:`RunReport.save_trace`).
``CompiledProgram.explain(trace=report)`` accepts it directly — the
mispredict columns render from the report's trace.
"""

from __future__ import annotations

import json
from typing import Any, Optional

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import timeline as _timeline


class RunReport:
    """Aggregate view of one recorded run.

    ``trace`` is a :class:`~repro_torch.tune.trace.ProgramTrace` (any source:
    sim / instrumented / stagewise); ``compiled`` (optional) unlocks the
    per-stage explain table and drift analysis against the program's
    topology; ``recorder`` contributes the counter snapshot.
    """

    def __init__(self, trace=None, *, compiled=None,
                 recorder: Optional[_metrics.Recorder] = None,
                 topology=None, name: Optional[str] = None):
        self.trace = trace
        self.compiled = compiled
        self.recorder = recorder
        self.topology = topology if topology is not None \
            else getattr(compiled, "topology", None)
        self.name = name or getattr(trace, "name", None) \
            or getattr(getattr(compiled, "source", None), "name", None) \
            or "run"
        self._watchdog = None

    # -- assembly ------------------------------------------------------------

    @classmethod
    def from_run(cls, compiled, trace,
                 recorder: Optional[_metrics.Recorder] = None,
                 threshold: float = 1.5) -> "RunReport":
        """Build the report for one (program, recording) pair and run the
        drift watchdog over it."""
        from repro_torch.obs.drift import DriftWatchdog

        rep = cls(trace, compiled=compiled, recorder=recorder)
        wd = DriftWatchdog(threshold=threshold, recorder=recorder)
        if compiled is not None and trace is not None \
                and rep.topology is not None:
            wd.observe(compiled.plan, rep.topology, trace)
        rep._watchdog = wd
        return rep

    @property
    def watchdog(self):
        return self._watchdog

    def drift_alerts(self) -> list:
        return self._watchdog.alerts() if self._watchdog is not None else []

    # -- output --------------------------------------------------------------

    def timeline(self) -> dict:
        """The Perfetto/Chrome trace-event dict for this run."""
        if self.trace is None:
            raise ValueError("report has no trace to export")
        return _timeline.chrome_trace(
            self.trace, getattr(self.compiled, "plan", None),
            name=self.name)

    def save_trace(self, path) -> str:
        return _timeline.save(path, self.timeline())

    def text(self) -> str:
        """The run, readable: explain table (or trace summary), drift
        verdict, counter snapshot."""
        lines: list[str] = []
        if self.compiled is not None:
            lines.append(self.compiled.explain(trace=self.trace))
        elif self.trace is not None:
            tr = self.trace
            lines.append(f"trace {self.name!r} ({len(tr.stages)} stages, "
                         f"source={getattr(tr, 'source', 'unknown')}, "
                         f"t_end={tr.t_end * 1e6:.1f}us)")
            per_axis: dict[str, float] = {}
            for s in tr.stages:
                per_axis[s.axis or "(local)"] = \
                    per_axis.get(s.axis or "(local)", 0.0) + s.duration
            for ax in sorted(per_axis):
                lines.append(f"  {ax}: {per_axis[ax] * 1e6:.1f}us serial")
        else:
            lines.append(f"run {self.name!r}: no trace recorded")
        if self._watchdog is not None:
            lines.append(self._watchdog.report())
        if self.recorder is not None:
            lines.append("counters:")
            for ln in self.recorder.summary().splitlines():
                lines.append(f"  {ln}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        """Machine-readable aggregate (JSON-able dict)."""
        out: dict[str, Any] = {"name": self.name}
        if self.trace is not None:
            tr = self.trace
            out["trace"] = {
                "source": getattr(tr, "source", "unknown"),
                "t_end": tr.t_end,
                "t_serial": sum(s.duration for s in tr.stages),
                "stages": len(tr.stages),
                "axes": dict(getattr(tr, "axes", {})),
            }
        if self._watchdog is not None:
            out["drift"] = {
                "threshold": self._watchdog.threshold,
                "alerts": [a.describe() for a in self.drift_alerts()],
                "refit_recommended": bool(self.drift_alerts()),
            }
        if self.recorder is not None:
            out["metrics"] = self.recorder.snapshot()
        if self.compiled is not None:
            out["program"] = {
                "stages": len(self.compiled.stages),
                "waves": self.compiled.plan.n_waves,
                "axes": self.compiled.axes(),
            }
        return out

    def save(self, path) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")
        return str(path)
