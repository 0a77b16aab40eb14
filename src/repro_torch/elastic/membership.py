"""Membership — the runtime's view of which ranks are alive.

The elastic story splits cleanly in two: the *mechanism* lives in the
compiler (``tracing.masked_reduce`` folds the live count into the payload
ring; the alive mask is a runtime program input so membership flips never
retrace), and the *policy* lives here — who is alive, decided from
measured per-rank spans against a deadline, and what a membership change
means for the compiled artifacts (:class:`TopologyDelta` →
``engine.recompile``).

Rank numbering convention: ``rank = outer_index * |inner| + inner_index``
— the flat row-major order of a ``(outer, inner)`` mesh, matching
``CollectiveEngine._local_alive`` and ``SwitchSim``'s device order.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Optional

from repro_torch.obs import metrics as _obs


@dataclasses.dataclass(frozen=True)
class TopologyDelta:
    """What changed between two membership views / network states.

    ``axis_sizes`` stays ``None`` for every change the alive mask can
    absorb (rank dropout, rank return, ×k link degradation): those are
    *shape-preserving* — rank-local buffer shapes don't move, so
    ``engine.recompile`` reuses the cached program and arenas outright.
    Set ``axis_sizes`` only when ranks actually leave the ring (the mesh
    shrinks) and every rank's shard shapes change with it.
    """

    dropped: tuple[int, ...] = ()
    restored: tuple[int, ...] = ()
    # ((axis, k), ...): links on `axis` degraded to 1/k bandwidth
    degraded_links: tuple[tuple[str, float], ...] = ()
    # {axis: new_size} when the mesh itself changes — forces full recompile
    axis_sizes: Optional[tuple[tuple[str, int], ...]] = None

    @property
    def shape_preserving(self) -> bool:
        return self.axis_sizes is None

    def __bool__(self) -> bool:
        return bool(self.dropped or self.restored or self.degraded_links
                    or self.axis_sizes is not None)


@dataclasses.dataclass(frozen=True)
class Membership:
    """Immutable alive-mask over ``n_ranks`` linear ranks.

    Feed it to ``engine.gradient_sync(..., membership=...)`` (the mask
    becomes a runtime input of the compiled masked sync) and to
    ``engine.recompile(membership_a.delta(membership_b), ...)`` when it
    changes.  Build verdicts from measured spans with
    :meth:`from_rank_times` / :meth:`from_report`.
    """

    alive: tuple[bool, ...]

    def __post_init__(self):
        object.__setattr__(self, "alive",
                           tuple(bool(a) for a in self.alive))
        if not self.alive:
            raise ValueError("membership over zero ranks")

    # -- constructors --------------------------------------------------------

    @classmethod
    def all_alive(cls, n_ranks: int) -> "Membership":
        return cls((True,) * n_ranks)

    @classmethod
    def from_rank_times(cls, rank_times: Iterable[float],
                        deadline_s: float) -> "Membership":
        """Deadline verdicts from measured per-rank sync spans (seconds):
        a rank is alive iff it finished within the deadline."""
        return cls(tuple(t <= deadline_s for t in rank_times))

    @classmethod
    def from_report(cls, report, deadline_s: float) -> "Membership":
        """Verdicts from a :class:`repro_torch.cgra.simulate.SimReport` (or any
        object with ``rank_t_end``: per-rank completion times)."""
        return cls.from_rank_times(report.rank_t_end, deadline_s)

    # -- views ---------------------------------------------------------------

    @property
    def n_ranks(self) -> int:
        return len(self.alive)

    @property
    def n_alive(self) -> int:
        return sum(self.alive)

    @property
    def dead(self) -> tuple[int, ...]:
        return tuple(r for r, a in enumerate(self.alive) if not a)

    def mask_array(self, dtype=None):
        """The alive mask as a torch tensor (float32 by default, on the
        CPU) — what ``gradient_sync`` broadcasts over the rank dims of the
        mesh at runtime (``CollectiveEngine._local_alive``)."""
        import torch

        return torch.tensor(self.alive, dtype=dtype or torch.float32)

    # -- updates -------------------------------------------------------------

    def drop(self, *ranks: int) -> "Membership":
        bad = [r for r in ranks if not 0 <= r < self.n_ranks]
        if bad:
            raise ValueError(f"ranks {bad} out of range 0..{self.n_ranks-1}")
        dead = set(ranks)
        return Membership(tuple(a and r not in dead
                                for r, a in enumerate(self.alive)))

    def restore(self, *ranks: int) -> "Membership":
        back = set(ranks)
        return Membership(tuple(a or r in back
                                for r, a in enumerate(self.alive)))

    def merge(self, other: "Membership") -> "Membership":
        """Intersection: alive only where both views agree."""
        if other.n_ranks != self.n_ranks:
            raise ValueError("membership size mismatch")
        return Membership(tuple(a and b
                                for a, b in zip(self.alive, other.alive)))

    def delta(self, new: "Membership",
              degraded_links: Optional[Mapping[str, float]] = None,
              axis_sizes: Optional[Mapping[str, int]] = None
              ) -> TopologyDelta:
        """The :class:`TopologyDelta` taking this view to ``new``."""
        if new.n_ranks != self.n_ranks:
            raise ValueError("membership size mismatch")
        dropped = tuple(r for r in range(self.n_ranks)
                        if self.alive[r] and not new.alive[r])
        restored = tuple(r for r in range(self.n_ranks)
                         if not self.alive[r] and new.alive[r])
        d = TopologyDelta(
            dropped=dropped, restored=restored,
            degraded_links=tuple(sorted((degraded_links or {}).items())),
            axis_sizes=tuple(sorted(axis_sizes.items()))
            if axis_sizes else None)
        if dropped:
            _obs.RECORDER.count("elastic.rank_dropped", len(dropped))
        if restored:
            _obs.RECORDER.count("elastic.rank_restored", len(restored))
        return d
