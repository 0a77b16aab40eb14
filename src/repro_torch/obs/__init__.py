"""Telemetry: counters/histograms (:mod:`.metrics`) and stage spans
(:mod:`.spans`) — copies of the reference's stdlib-only modules."""

from repro_torch.obs import metrics, spans
from repro_torch.obs.metrics import (NullRecorder, Recorder, current,
                                     install, recording)
from repro_torch.obs.spans import StageSpan

__all__ = ["metrics", "spans", "NullRecorder", "Recorder", "current",
           "install", "recording", "StageSpan"]
