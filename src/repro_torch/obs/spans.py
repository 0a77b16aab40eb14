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

The same module holds the span log's facility, :func:`span`: a named
region of the program (``train.step``, ``sync.call``, one
``stage.<label>`` an executed stage) recorded into the process
recorder's span log when it keeps one (``obs.recording(spans=True)``);
while a profiler records, also as ``torch.profiler.record_function(
"acis." + name)``, so that its trace shows the span on the same clock as
the device's kernels.
Stage spans are records of this log too; :class:`StageSpan` stays the
record the executor's ``instrument`` hook, ``tune`` and ``timeline``
use.

Kept dependency-free (stdlib only; torch is imported only while spans
are recorded) so both ``repro_torch.core`` and ``repro_torch.tune`` can
import it without a cycle.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

from repro_torch.obs import metrics as _metrics


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


# ---------------------------------------------------------------------------
# the span log
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpanRecord:
    """One region the program ran under :func:`span`.

    ``parent`` is the log index of the span it ran inside (None for a
    root); ``id`` counts the roots of one name (the step or the call) and
    is shared by every span under that root: it comes from the host, never
    from a device tensor.  ``t0_ns``/``t1_ns`` are host ``perf_counter_ns``
    at entry and exit; ``device_ms`` is the time between the span's two
    CUDA events on the stream it ran on, set when the recording resolves
    (None for a span recorded without the card).
    """

    name: str
    parent: Optional[int]
    id: int
    t0_ns: int
    t1_ns: int = 0
    device_ms: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                compare=False)

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6

    def to_dict(self) -> dict:
        return {"name": self.name, "parent": self.parent, "id": self.id,
                "t0_ns": self.t0_ns, "t1_ns": self.t1_ns,
                "device_ms": self.device_ms}


class _Noop:
    """The context :func:`span` returns while no span log is kept."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Span:
    __slots__ = ("rec", "name", "index", "fn")

    def __init__(self, rec, name: str):
        self.rec, self.name, self.index, self.fn = rec, name, None, None

    def __enter__(self):
        import torch

        rec = self.rec
        log = rec.spans
        if len(log) >= _metrics.MAX_EVENTS:
            rec.dropped_spans += 1
            return None
        parent = rec.open_spans[-1] if rec.open_spans else None
        if parent is None:
            ident = rec.roots.get(self.name, 0)
            rec.roots[self.name] = ident + 1
        else:
            ident = log[parent].id
        if torch.autograd._profiler_enabled():
            # a range only a running profiler sees: ~10 us a span spared
            # without one
            self.fn = torch.profiler.record_function("acis." + self.name)
            self.fn.__enter__()
        events = None
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        self.index = len(log)
        log.append(SpanRecord(self.name, parent, ident,
                              time.perf_counter_ns(), events=events))
        rec.open_spans.append(self.index)
        return None

    def __exit__(self, *exc):
        if self.index is None:
            return False
        rec = self.rec
        s = rec.spans[self.index]
        s.t1_ns = time.perf_counter_ns()
        if s.events is not None:
            s.events[1].record()
        rec.open_spans.pop()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


def span(name: str):
    """A context manager over the region ``name``: while the process
    recorder keeps a span log it takes the host clock at both ends,
    records a CUDA-event pair on the current stream when CUDA is in use,
    appends a :class:`SpanRecord` (name, enclosing span, step or call
    id) and, while a profiler records, enters
    ``torch.profiler.record_function("acis." + name)``.  It never
    synchronises.  Without a span log it returns the one shared no-op
    context."""
    rec = _metrics.RECORDER
    if rec.spans is None:
        return NOOP
    return _Span(rec, name)
