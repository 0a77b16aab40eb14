"""Deadline-bounded sync: retry/backoff around the masked collective.

The compiled masked sync (``gradient_sync(membership=...)``) is a pure
mechanism — it reduces whatever the mask says is alive.  This module is
the host-side control loop around it: run a sync attempt, judge each
rank's measured completion time against the deadline, mask the late
ranks, and retry with a backed-off deadline so a *transient* divergence
(one slow attempt) doesn't permanently evict a healthy rank's pod —
permanent eviction is the caller's decision, taken from the returned
membership.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from repro_torch.elastic.membership import Membership
from repro_torch.obs import metrics as _obs


class ElasticSyncError(RuntimeError):
    """Retries exhausted (or every rank went dead) without a clean sync."""


@dataclasses.dataclass(frozen=True)
class SyncOutcome:
    """One deadline-bounded sync: the result of the last attempt, the
    membership after deadline verdicts, and how hard we had to try."""

    result: object
    membership: Membership
    attempts: int
    deadline_s: float            # the (possibly backed-off) final deadline
    masked: tuple[int, ...] = ()  # ranks masked across all attempts


def sync_with_deadline(
    run: Callable[[Membership, float], tuple[object, Sequence[float]]],
    membership: Membership,
    *,
    deadline_s: float,
    max_retries: int = 3,
    backoff: float = 2.0,
) -> SyncOutcome:
    """Run ``run(membership, deadline_s) -> (result, rank_times)`` until
    every *alive* rank meets the deadline.

    Ranks over the deadline are masked (they stop contributing — the
    masked collective renormalizes by the live count) and the attempt is
    retried with the shrunk membership and a ×``backoff`` deadline, up
    to ``max_retries`` retries.  An attempt with no late ranks returns
    immediately; its result IS the sync result — late ranks' data from
    *earlier* attempts is never mixed in.

    Raises :class:`ElasticSyncError` when retries are exhausted with
    ranks still missing the deadline, or when masking would kill the
    last alive rank.
    """
    if membership.n_alive == 0:
        raise ElasticSyncError("no alive ranks to sync over")
    deadline = float(deadline_s)
    masked_total: list[int] = []
    for attempt in range(1, max_retries + 2):
        result, times = run(membership, deadline)
        late = tuple(r for r, t in enumerate(times)
                     if r < membership.n_ranks and membership.alive[r]
                     and t > deadline)
        if not late:
            return SyncOutcome(result=result, membership=membership,
                               attempts=attempt, deadline_s=deadline,
                               masked=tuple(masked_total))
        _obs.RECORDER.count("elastic.deadline_miss", len(late))
        _obs.RECORDER.event("elastic.deadline_miss", attempt=attempt,
                            late=list(late), deadline_s=deadline)
        membership = membership.drop(*late)
        masked_total.extend(late)
        if membership.n_alive == 0:
            raise ElasticSyncError(
                f"every rank missed the {deadline:g}s deadline "
                f"(attempt {attempt})")
        if attempt == max_retries + 1:
            break
        deadline *= backoff
        _obs.RECORDER.count("elastic.retry")
    raise ElasticSyncError(
        f"ranks {late} still over deadline after {max_retries} retries")


def deadline_verdicts(rank_times: Sequence[float], deadline_s: float,
                      *, membership: Optional[Membership] = None
                      ) -> Membership:
    """Pure verdict helper: alive iff within deadline (intersected with
    an existing membership when given — a dead rank stays dead even if
    its reported time is stale-small)."""
    fresh = Membership.from_rank_times(rank_times, deadline_s)
    return fresh if membership is None else membership.merge(fresh)
