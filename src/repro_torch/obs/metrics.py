"""Events + metrics registry: process-local counters, gauges, histograms.

The rest of the repo emits into the module-level :data:`RECORDER`
(default :data:`null_recorder`, whose every method is a no-op) — so with
recording disabled an instrumented site costs one module-attribute read
plus an empty method call, and ``benchmarks/obs.py`` gates that bound in
CI.  Enable collection for a region with :func:`recording`::

    from repro_torch import obs

    with obs.recording() as rec:
        engine.gradient_sync(...)          # or compile / simulate / serve
    print(rec.summary())

Counter catalogue (every name the repo currently emits):

========================  ==========  =====================================
name                      type        emitted by
========================  ==========  =====================================
compile.programs          counter     compiler.compile_rank_local per build
compile.cache_hit/_miss   counter     api.CollectiveEngine._sync_program
tune.db_hit/db_search     counter     tune.search.tuned_config
tune.fit_runs             counter     tune.fit.fit_net_params
arena.alloc/realloc       counter     api.CollectiveEngine.init_arenas
arena.roundtrip           counter     api gradient_sync arena threading
coalesce.bucket_fill_frac histogram   Coalesce bucket formation (bytes/cap)
emit.kernel_stage         counter     Emit under use_kernels (CUDA kernels)
emit.reference_stage      counter     Emit reference lowering
cgra.placed/host_fallback counter     compile placements (PlaceCGRA result)
plan.stage_bytes          histogram   per-stage payload at compile
plan.wave_width           histogram   stages per ExecutionPlan wave
exec.instrumented_stages  counter     executor instrument hook
exec.stage_s              histogram   instrumented per-stage seconds
sim.runs/sim.stages       counter     cgra.simulate.SwitchSim.run
serve.ticks/admitted/     counter     serve.ServeEngine.step
  retired
serve.active              gauge       active slots per tick
serve.queue_depth         gauge       queued requests at tick start
serve.decode_s            histogram   per-tick decode seconds (enabled only)
serve.decode_p50_s/p99_s  gauge       tick-latency percentiles over the
                                      sliding measurement window
serve.host_sync           counter     the tick's one device->host block
                                      (the greedy tokens)
serve.slo_rejected        counter     requests dropped at admission: the
                                      SLOPolicy estimate misses deadline
serve.admit_deferred      counter     admits postponed (prefill cap)
serve.deadline_headroom_s gauge       min (deadline - elapsed) across
                                      active deadline-carrying slots
serve.program_cache_hit/  counter     serve.collectives.SwitchProgramCache
  _miss                               get_or_build
train.steps               counter     train step wrapper (recorder= passed)
train.step_s              histogram   per-step seconds (enabled only)
drift.observations        counter     obs.drift.DriftWatchdog.observe
drift.rank_observations   counter     watchdog per-rank span pools
drift.flagged             counter     watchdog keys past threshold
drift.rank_local/         counter     local verdicts (sick rank / degraded
  link_local                          link) — reported, refit suppressed
drift.refit_recommended   event       watchdog re-fit recommendation
tune.fit                  event       fit residual/stage count per fit
elastic.deadline_miss     counter     sync_with_deadline ranks past deadline
elastic.retry             counter     sync_with_deadline masked retries
elastic.rank_dropped/     counter     Membership.delta transitions
  rank_restored
recompile.programs_reused counter     engine.recompile cache outcomes
  /_rebuilt
recompile.arenas_reused/  counter     engine.recompile arena outcomes
  _rebuilt
topology.compile_cache_   counter     bounded LRU evictions from the
  evicted                             process-wide topology compile cache
sim.dead_ranks            counter     SwitchSim FaultPlan dead ranks per run
========================  ==========  =====================================
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Iterator, Optional

# events kept per recorder before dropping (with a drop counter) — a
# telemetry layer must never be the thing that OOMs the run
MAX_EVENTS = 65536


@dataclasses.dataclass
class Hist:
    """Running aggregate of an observed distribution (no sample storage
    beyond the aggregate — O(1) per observe)."""

    n: int = 0
    total: float = 0.0
    sq: float = 0.0
    mn: float = math.inf
    mx: float = -math.inf

    def add(self, value: float) -> None:
        v = float(value)
        self.n += 1
        self.total += v
        self.sq += v * v
        self.mn = min(self.mn, v)
        self.mx = max(self.mx, v)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def to_dict(self) -> dict:
        return {"n": self.n, "mean": self.mean,
                "min": self.mn if self.n else 0.0,
                "max": self.mx if self.n else 0.0,
                "total": self.total}


class Recorder:
    """Collects counters / gauges / histograms / events.

    Not thread-safe by design — one recorder per measured region; the
    hot paths it instruments are single-threaded host loops.
    """

    enabled = True

    def __init__(self):
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.hists: dict[str, Hist] = {}
        self.events: list[tuple[str, dict]] = []
        self.dropped_events = 0

    # -- emission ------------------------------------------------------------

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        h = self.hists.get(name)
        if h is None:
            h = self.hists[name] = Hist()
        h.add(value)

    def event(self, name: str, **fields) -> None:
        if len(self.events) >= MAX_EVENTS:
            self.dropped_events += 1
            return
        self.events.append((name, fields))

    # -- reading -------------------------------------------------------------

    def counter(self, name: str) -> float:
        return self.counters.get(name, 0)

    def snapshot(self) -> dict:
        """Everything collected, as plain JSON-able data."""
        out = {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "hists": {k: h.to_dict() for k, h in self.hists.items()},
            "events": [{"name": n, **f} for n, f in self.events],
        }
        if self.dropped_events:
            out["dropped_events"] = self.dropped_events
        return out

    def summary(self) -> str:
        """A readable multi-line dump, names sorted."""
        lines = []
        for k in sorted(self.counters):
            lines.append(f"{k} = {self.counters[k]:g}")
        for k in sorted(self.gauges):
            lines.append(f"{k} = {self.gauges[k]:g} (gauge)")
        for k in sorted(self.hists):
            h = self.hists[k]
            lines.append(f"{k}: n={h.n} mean={h.mean:g} "
                         f"min={h.mn:g} max={h.mx:g}")
        for name, fields in self.events:
            args = ", ".join(f"{k}={v}" for k, v in fields.items())
            lines.append(f"event {name}({args})")
        return "\n".join(lines) if lines else "(nothing recorded)"

    def clear(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.hists.clear()
        self.events.clear()
        self.dropped_events = 0


class NullRecorder(Recorder):
    """The disabled default: every emission is a no-op, every read is
    empty.  Instrumented sites pay one attribute read + one empty call."""

    enabled = False

    def count(self, name, n=1):
        pass

    def gauge(self, name, value):
        pass

    def observe(self, name, value):
        pass

    def event(self, name, **fields):
        pass


null_recorder = NullRecorder()

# the process-wide recorder instrumented sites emit into.  Read it at
# call time (``metrics.RECORDER.count(...)``) — never bind it at import —
# so ``recording()`` swaps take effect everywhere.
RECORDER: Recorder = null_recorder


def current() -> Recorder:
    return RECORDER


def install(recorder: Optional[Recorder]) -> Recorder:
    """Make ``recorder`` (or the null recorder) the process recorder;
    returns the previous one so callers can restore it."""
    global RECORDER
    prev = RECORDER
    RECORDER = recorder if recorder is not None else null_recorder
    return prev


@contextlib.contextmanager
def recording(recorder: Optional[Recorder] = None) -> Iterator[Recorder]:
    """Install a recorder for the ``with`` body (a fresh one when not
    given), restoring the previous recorder on exit."""
    rec = recorder if recorder is not None else Recorder()
    prev = install(rec)
    try:
        yield rec
    finally:
        install(prev)
