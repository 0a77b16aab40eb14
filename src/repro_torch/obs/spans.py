"""The shared stage-record schema — one span type for every recorder.

A :class:`StageSpan` is one executed (or simulated) plan stage with
wall-clock boundaries plus the identity fields a replayer or exporter
matches on.  It is the single currency of the observability layer:

  * :func:`repro_torch.core.executor.execute` appends ``StageSpan`` records to
    its ``instrument`` hook (one per executed stage);
  * :mod:`repro_torch.tune.trace` *is* this schema — ``tune.trace.StageTrace``
    is an alias of :class:`StageSpan`, so obs spans and tune traces are
    the same objects, not parallel formats needing conversion;
  * :mod:`repro_torch.obs.timeline` exports sequences of spans (or anything
    span-shaped, e.g. a simulator ``SimStage``) as Chrome trace-event
    JSON.

Kept dependency-free (stdlib only) so both ``repro_torch.core`` and
``repro_torch.tune`` can import it without a cycle.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class StageSpan:
    """One executed stage: identity + wall-clock boundaries.

    ``stage`` indexes the owning plan's stage list; ``bytes`` is the raw
    per-rank payload (``StageIR.bytes_in``) so a replayer can match this
    record against stages of a *different* candidate plan; ``t_ser`` is
    the injection-serialization share of the duration when the recorder
    knows it (the simulator does; wall-clock recorders leave it None and
    the replayer falls back to the calibrated per-tier overlap
    fraction).
    """

    stage: int
    kind: str
    axis: str = ""
    wave: int = 0
    t_start: float = 0.0
    t_end: float = 0.0
    bytes: Optional[int] = None
    schedule: str = ""
    placement: str = ""
    t_ser: Optional[float] = None

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


def normalize(spans: Sequence[StageSpan]) -> tuple[StageSpan, ...]:
    """The same spans shifted so the earliest ``t_start`` is 0."""
    t0 = min((s.t_start for s in spans), default=0.0)
    if not t0:
        return tuple(spans)
    return tuple(dataclasses.replace(s, t_start=s.t_start - t0,
                                     t_end=s.t_end - t0) for s in spans)


def from_stage(stage, index: int, wave: int, t_start: float,
               t_end: float) -> StageSpan:
    """A span for one plan stage, pulling identity/payload metadata off
    the stage itself (duck-typed: plans are deliberately dumb data, so
    every field degrades to its default when absent)."""
    ir = getattr(stage, "ir", None)
    pl = getattr(stage, "placement", None)
    return StageSpan(
        stage=index,
        kind=getattr(stage, "kind", ""),
        axis=getattr(stage, "axis", "") or "",
        wave=wave,
        t_start=t_start,
        t_end=t_end,
        bytes=getattr(ir, "bytes_in", None) if ir is not None else None,
        schedule=getattr(stage, "schedule", "") or "",
        placement=pl.describe() if pl is not None else "")
