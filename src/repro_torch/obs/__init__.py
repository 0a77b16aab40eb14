"""repro_torch.obs — unified switch telemetry (the PyTorch counterpart of
:mod:`repro.obs`).

  1. **metrics** (:mod:`.metrics`) — process-local counters / gauges /
     histograms behind a :class:`~repro_torch.obs.metrics.Recorder`
     (a no-op ``null_recorder`` by default — enable with
     :func:`~repro_torch.obs.metrics.recording`).
  2. **spans** (:mod:`.spans`) — the shared stage-record schema;
     ``tune.trace.StageTrace`` *is* :class:`~repro_torch.obs.spans.
     StageSpan`, and the executor's ``instrument`` hook emits it.
  3. **timeline** (:mod:`.timeline`) — spans (executor *or* simulator)
     as Chrome trace-event JSON loadable in Perfetto.
  4. **drift** (:mod:`.drift`) — measured-vs-model ratio tracking that
     recommends a re-fit (:mod:`repro_torch.tune.fit`).

:class:`~repro_torch.obs.report.RunReport` aggregates one run;
``python -m repro_torch.obs`` renders a report or dumps a ``.trace.json``
from a recorded JSONL trace.

``spans``/``metrics``/``timeline`` are stdlib-only so ``repro_torch.core``
imports them without a cycle; ``drift``/``report`` (which reach into
``repro_torch.core.netmodel`` / ``repro_torch.tune``) load lazily.
"""

from repro_torch.obs import metrics, spans, timeline
from repro_torch.obs.metrics import (NullRecorder, Recorder, current,
                                     install, null_recorder, recording)
from repro_torch.obs.spans import StageSpan
from repro_torch.obs.timeline import chrome_trace

__all__ = [
    "metrics", "spans", "timeline", "drift", "report",
    "Recorder", "NullRecorder", "null_recorder", "current", "install",
    "recording", "StageSpan", "chrome_trace",
    "DriftWatchdog", "DriftAlert", "DriftVerdict", "RunReport",
]

_LAZY = {
    "drift": "repro_torch.obs.drift",
    "report": "repro_torch.obs.report",
    "DriftWatchdog": "repro_torch.obs.drift",
    "DriftAlert": "repro_torch.obs.drift",
    "DriftVerdict": "repro_torch.obs.drift",
    "RunReport": "repro_torch.obs.report",
}


def __getattr__(name):
    # drift/report import repro_torch.core (netmodel) — deferred so that
    # repro_torch.core.executor can import repro_torch.obs at module level
    # without a circular import through the package __init__
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(
            f"module 'repro_torch.obs' has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(target)
    value = mod if name in ("drift", "report") else getattr(mod, name)
    globals()[name] = value
    return value
