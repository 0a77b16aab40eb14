"""Device-queue replay: score a candidate plan against a recorded trace.

The searcher needs to rank plan variants (bucket sizes, schedules,
dispatch modes) in microseconds, not by re-running JAX.  The replayer
walks a candidate :class:`~repro_torch.core.executor.ExecutionPlan` wave by
wave, advancing one queue per mesh axis exactly like the runtime's
dispatch groups: stages sharing an axis serialize on its queue, queues
of one wave run concurrently and the wave ends at the longest queue
plus the *other* queues' exposed (injection-serialization) share — the
same merge the dataplane simulator performs and the analytic
``program_time`` prices.

Per stage the replayer prefers **measured** time: a recorded stage with
the same (kind, axis, schedule, payload bytes) is popped from the trace
(each record used at most once) and contributes its recorded duration
and — when the recorder knew it — its recorded serialization share.
Stages with no matching record (the candidate plan reshaped the work)
fall back to the analytic model, under fitted parameters when a
:class:`~repro_torch.tune.fit.NetFit` is given.  With an empty trace the
replayed time therefore *is* ``netmodel.program_time``; with a full
self-trace it reproduces the recording — the two fixed points the tests
pin.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

from repro_torch.core import netmodel


@dataclasses.dataclass(frozen=True)
class StageScore:
    """How one candidate-plan stage was priced during a replay."""

    stage: int
    kind: str
    axis: str
    t: float
    source: str                    # "measured" | "model"


@dataclasses.dataclass(frozen=True)
class ReplayResult:
    t_end: float
    stages: tuple[StageScore, ...]
    matched: int
    modeled: int

    @property
    def match_fraction(self) -> float:
        n = self.matched + self.modeled
        return self.matched / n if n else 0.0


def _match_key(kind: str, axis: str, schedule: str,
               nbytes: Optional[int]) -> tuple:
    return (kind, axis, schedule, nbytes)


def _pool(trace) -> dict:
    """Recorded stages as FIFO queues per match key — a candidate stage
    consumes at most one record, in recorded order (deterministic)."""
    pool: dict = collections.defaultdict(collections.deque)
    if trace is None:
        return pool
    for ts in getattr(trace, "stages", trace):
        pool[_match_key(ts.kind, ts.axis, ts.schedule, ts.bytes)].append(
            (ts.duration, ts.t_ser))
    return pool


def replay(plan, trace=None, topo=None, *,
           fit=None, p: netmodel.NetParams = netmodel.PAPER,
           overlap: Optional[dict] = None,
           overlapped: bool = True) -> ReplayResult:
    """Score ``plan`` against ``trace``.

    ``topo`` is the candidate's compile topology (axis sizes + tiers);
    ``fit`` substitutes fitted link parameters and overlap fractions for
    the model-priced stages (:class:`~repro_torch.tune.fit.NetFit`);
    ``overlapped=False`` scores the serial dispatch mode (every queue of
    a wave serializes — the ``overlap_dispatch=False`` runtime).  The
    same inputs always produce the identical score: the replay is pure
    arithmetic over the recording.
    """
    if fit is not None:
        topo = fit.wrap(topo) if topo is not None else topo
        p = fit.params()
        ov = dict(netmodel.TIER_OVERLAP)
        ov.update(fit.overlap)
    else:
        ov = dict(netmodel.TIER_OVERLAP)
    if overlap:
        ov.update(overlap)

    pool = _pool(trace)
    scores: list[StageScore] = []
    matched = modeled = 0
    t_total = 0.0
    for wave in plan.waves:
        # one queue per axis ('' pools the axis-less local stages, whose
        # 'local' tier overlap is 1.0 — never re-exposed)
        chain: dict[str, float] = {}
        exposed: dict[str, float] = {}
        for i in wave:
            st = plan.stages[i]
            ir = getattr(st, "ir", None)
            key = _match_key(st.kind, st.axis, st.schedule,
                             getattr(ir, "bytes_in", None))
            q = pool.get(key)
            tier = netmodel._tier_of(st.axis, topo)
            if q:
                dt, ser = q.popleft()
                matched += 1
                src = "measured"
            else:
                dt = netmodel.plan_stage_time(st, topo, p) or 0.0
                ser = None
                modeled += 1
                src = "model"
            if ser is None:
                ser = (1.0 - ov.get(tier, 1.0)) * dt
            chain[st.axis] = chain.get(st.axis, 0.0) + dt
            exposed[st.axis] = exposed.get(st.axis, 0.0) + ser
            scores.append(StageScore(i, st.kind, st.axis, dt, src))
        if not chain:
            continue
        if not overlapped:
            t_total += sum(chain.values())
            continue
        critical = max(chain, key=chain.get)
        t_total += chain[critical] + sum(
            e for ax, e in exposed.items() if ax != critical)
    return ReplayResult(t_end=t_total, stages=tuple(scores),
                        matched=matched, modeled=modeled)
