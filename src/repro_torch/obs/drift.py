"""Model-drift watchdog: measured vs ``plan_stage_time``, online.

The paper's software loop is evaluate → map → refine (§V): the analytic
network model plans, recordings evaluate, and when the two diverge the
model must be *re-fitted* from the recordings (:mod:`repro_torch.tune.fit`).
This module is the tripwire between those phases.

A :class:`DriftWatchdog` consumes recorded stage spans (simulator or
instrumented executor — the shared :class:`~repro_torch.obs.spans.StageSpan`
schema), tracks the geometric-mean measured/model ratio per
``(kind, axis, schedule, bytes-bucket)`` key, and flags keys whose ratio
drifts past a threshold in either direction.  When any key is flagged it
emits a ``drift.refit_recommended`` event into the metrics recorder and
:meth:`DriftWatchdog.refit` hands the accumulated samples straight to
:func:`repro_torch.tune.fit.fit_traces` — closing the loop.

Not every divergence means the *model* is stale: a sick rank or a
degraded link drifts the measurements too, and re-fitting the global
model to a local fault would poison it.  :meth:`DriftWatchdog.classify`
separates the cases from two extra signals — per-rank span pools
(:meth:`observe_ranks`, each rank's completion time against the peer
median: a straggler pools high, a dead rank pools vanishingly low, a
uniform model shift pools at 1 for every rank) and the per-axis spread
of the flagged keys (one axis drifted while another stays quiet = that
*link*, not the model).  :meth:`refit_recommended` then stays quiet on
rank-/link-local faults (``drift.rank_local`` / ``drift.link_local``
events instead), recommending a re-fit only for global drift.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.obs import metrics as _metrics

# a key must accumulate this many priced samples before it can fire —
# one noisy stage is a measurement, not a drift
DEFAULT_MIN_SAMPLES = 2
DEFAULT_THRESHOLD = 1.5


def bytes_bucket(nbytes: Optional[int]) -> int:
    """Log2 size bucket (0 for unknown payloads): stages within one
    bucket share a bandwidth regime, so their ratios pool."""
    if not nbytes or nbytes <= 0:
        return 0
    return max(int(nbytes).bit_length(), 1)


@dataclasses.dataclass(frozen=True)
class DriftAlert:
    """One drifted key: the pooled ratio and how far past threshold."""

    kind: str
    axis: str
    schedule: str
    bucket: int                    # log2 bytes bucket
    ratio: float                   # geometric-mean measured/model
    n: int                         # samples pooled

    @property
    def drift(self) -> float:
        """Symmetric drift magnitude: ``max(ratio, 1/ratio)``."""
        return max(self.ratio, 1.0 / self.ratio)

    def describe(self) -> str:
        return (f"{self.kind}@{self.axis or '-'}"
                f"[{self.schedule or '-'}, ~2^{self.bucket}B]: "
                f"meas/model x{self.ratio:.2f} over {self.n} stages")


@dataclasses.dataclass(frozen=True)
class DriftVerdict:
    """What a divergence *is*: model stale, rank sick, or link degraded.

    ``verdict`` is one of ``"quiet"`` (nothing flagged), ``"rank"``
    (specific ranks deviate from their peers — mask them, don't refit),
    ``"link"`` (specific axes' keys drift while other observed axes stay
    quiet — degrade that tier, don't refit), ``"global"`` (every signal
    shifted together — the model is stale, refit).
    """

    verdict: str
    ranks: tuple[int, ...] = ()
    axes: tuple[str, ...] = ()
    ratio: float = 1.0              # worst pooled ratio behind the verdict

    @property
    def local(self) -> bool:
        return self.verdict in ("rank", "link")

    def describe(self) -> str:
        where = ""
        if self.ranks:
            where = f" ranks={list(self.ranks)}"
        if self.axes:
            where += f" axes={list(self.axes)}"
        return f"{self.verdict}{where} (x{self.ratio:.2f})"


@dataclasses.dataclass
class _Cell:
    log_sum: float = 0.0
    n: int = 0

    @property
    def ratio(self) -> float:
        return math.exp(self.log_sum / self.n) if self.n else 1.0


class DriftWatchdog:
    """Online measured-vs-model ratio tracking over recorded runs.

    ``threshold`` is symmetric: a key fires when its pooled ratio leaves
    ``[1/threshold, threshold]`` with at least ``min_samples`` samples.
    ``recorder`` defaults to the process recorder at call time, so the
    watchdog's counters/events land wherever the run's telemetry does.
    """

    def __init__(self, threshold: float = DEFAULT_THRESHOLD,
                 min_samples: int = DEFAULT_MIN_SAMPLES,
                 recorder: Optional[_metrics.Recorder] = None):
        if threshold <= 1.0:
            raise ValueError(f"threshold must be > 1, got {threshold}")
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self._recorder = recorder
        self._cells: dict[tuple, _Cell] = {}
        self._samples: list[tuple] = []    # (plan, topo, trace) for refit
        # rank → peer-relative _Cell (completion time vs run median):
        # the signal that separates "rank sick" from "model stale"
        self._rank_cells: dict[int, _Cell] = {}

    def _rec(self) -> _metrics.Recorder:
        return self._recorder if self._recorder is not None \
            else _metrics.RECORDER

    # -- accumulation --------------------------------------------------------

    def observe(self, plan, topo, trace) -> int:
        """Fold one recorded run in; returns the number of priced spans.

        ``trace`` is a :class:`~repro_torch.tune.trace.ProgramTrace` (or a bare
        span sequence) recorded from ``plan``; spans whose stage index or
        kind doesn't match the plan, or whose payload the model cannot
        price, are skipped — cost what the model can see.
        """
        from repro_torch.core import netmodel

        rec = self._rec()
        spans = getattr(trace, "stages", trace)
        priced = 0
        for ts in spans:
            i = getattr(ts, "stage", -1)
            if not 0 <= i < len(plan.stages):
                continue
            st = plan.stages[i]
            if getattr(st, "kind", "") != ts.kind:
                continue
            model = netmodel.plan_stage_time(st, topo)
            meas = ts.duration
            if not model or meas <= 0.0:
                continue
            key = (ts.kind, ts.axis, ts.schedule,
                   bytes_bucket(getattr(ts, "bytes", None)))
            cell = self._cells.setdefault(key, _Cell())
            cell.log_sum += math.log(meas / model)
            cell.n += 1
            priced += 1
        if priced:
            self._samples.append((plan, topo, trace))
            rec.count("drift.observations", priced)
        return priced

    def observe_ranks(self, rank_times: Sequence[float]) -> int:
        """Fold one run's per-rank completion times (seconds) into the
        per-rank pools, each rank against the *peer median* of the run.

        The peer-relative framing is the classifier: a straggling rank
        pools high, a dead rank (frozen clock — it produced almost no
        spans) pools vanishingly low, while a stale model shifts every
        rank together and no rank deviates from the median at all.
        """
        ts = [max(float(t), 0.0) for t in rank_times]
        if len(ts) < 2:
            return 0
        ordered = sorted(ts)
        mid = len(ordered) // 2
        med = ordered[mid] if len(ordered) % 2 else \
            0.5 * (ordered[mid - 1] + ordered[mid])
        if med <= 0.0:
            return 0
        floor = 1e-6 * med            # dead rank: frozen at ~0 — clamp so
        #                               the log is finite but far past any
        #                               threshold
        for r, t in enumerate(ts):
            cell = self._rank_cells.setdefault(r, _Cell())
            cell.log_sum += math.log(max(t, floor) / med)
            cell.n += 1
        self._rec().count("drift.rank_observations", len(ts))
        return len(ts)

    def observe_report(self, report, topo=None) -> int:
        """Fold a :class:`~repro_torch.cgra.simulate.SimReport` in directly:
        per-stage simulated/model ratios into the key pools (the report
        carries its own ``t_model`` predictions) and ``rank_t_end`` into
        the per-rank pools.  Returns the number of priced stages."""
        rec = self._rec()
        priced = 0
        for s in report.stages:
            if not s.t_model or s.t_sim <= 0.0:
                continue
            key = (s.kind, s.axis, s.schedule, 0)
            cell = self._cells.setdefault(key, _Cell())
            cell.log_sum += math.log(s.t_sim / s.t_model)
            cell.n += 1
            priced += 1
        if priced:
            rec.count("drift.observations", priced)
        if getattr(report, "rank_t_end", ()):
            self.observe_ranks(report.rank_t_end)
        return priced

    # -- verdicts ------------------------------------------------------------

    def ratios(self) -> dict[tuple, tuple[float, int]]:
        """``{key: (geometric-mean ratio, n)}`` for every tracked key."""
        return {k: (c.ratio, c.n) for k, c in self._cells.items()}

    def alerts(self) -> list[DriftAlert]:
        """Keys past threshold, worst drift first."""
        out = []
        for (kind, axis, schedule, bucket), c in self._cells.items():
            if c.n < self.min_samples:
                continue
            r = c.ratio
            if max(r, 1.0 / r) > self.threshold:
                out.append(DriftAlert(kind, axis, schedule, bucket,
                                      ratio=r, n=c.n))
        out.sort(key=lambda a: -a.drift)
        return out

    def rank_alerts(self) -> list[tuple[int, float, int]]:
        """``(rank, peer-relative ratio, n)`` for every rank whose pooled
        ratio left ``[1/threshold, threshold]`` — straggler (high) or
        dead (vanishingly low) — worst first."""
        out = []
        for r, c in self._rank_cells.items():
            if c.n < self.min_samples:
                continue
            ratio = c.ratio
            if max(ratio, 1.0 / ratio) > self.threshold:
                out.append((r, ratio, c.n))
        out.sort(key=lambda t: -max(t[1], 1.0 / t[1]))
        return out

    def classify(self) -> DriftVerdict:
        """Attribute the observed divergence: ``rank`` / ``link`` /
        ``global`` / ``quiet``.

        Rank verdicts win (a sick rank also skews stage pools); a link
        verdict needs at least one *other* observed axis staying quiet —
        with a single axis in evidence a uniform drift is
        indistinguishable from a stale model, so it stays ``global``.
        """
        ranks = self.rank_alerts()
        if ranks:
            worst = ranks[0]
            return DriftVerdict("rank",
                                ranks=tuple(r for r, _, _ in ranks),
                                ratio=worst[1])
        alerts = self.alerts()
        if not alerts:
            return DriftVerdict("quiet")
        drifted = tuple(sorted({a.axis for a in alerts}))
        quiet = {axis for (_, axis, _, _), c in self._cells.items()
                 if c.n >= self.min_samples} - set(drifted)
        if quiet:
            return DriftVerdict("link", axes=drifted,
                                ratio=alerts[0].ratio)
        return DriftVerdict("global", axes=drifted,
                            ratio=alerts[0].ratio)

    def refit_recommended(self) -> bool:
        """True when the divergence is *global* — a stale model.  A
        rank- or link-local verdict is reported
        (``drift.rank_local`` / ``drift.link_local``) but does NOT
        recommend a refit: fitting the shared model to one sick rank or
        one degraded link would poison it for the healthy fabric."""
        verdict = self.classify()
        rec = self._rec()
        if verdict.verdict == "rank":
            rec.count("drift.rank_local", len(verdict.ranks))
            rec.event("drift.rank_local", ranks=list(verdict.ranks),
                      ratio=verdict.ratio)
            return False
        if verdict.verdict == "link":
            rec.count("drift.link_local", len(verdict.axes))
            rec.event("drift.link_local", axes=list(verdict.axes),
                      ratio=verdict.ratio)
            return False
        alerts = self.alerts()
        if not alerts:
            return False
        rec.count("drift.flagged", len(alerts))
        worst = alerts[0]
        rec.event("drift.refit_recommended",
                  worst=worst.describe(), ratio=worst.ratio,
                  keys=len(alerts), threshold=self.threshold)
        return True

    def refit(self, samples: Optional[Sequence] = None, **fit_kw):
        """Run :func:`repro_torch.tune.fit.fit_traces` over the accumulated
        ``(plan, topo, trace)`` samples (or explicit ones) — the re-fit
        the watchdog recommends.  Returns the :class:`~repro_torch.tune.fit.
        NetFit`."""
        from repro_torch.tune import fit as _fit

        use = list(samples) if samples is not None else list(self._samples)
        if not use:
            raise ValueError("no recorded samples to re-fit from")
        self._rec().count("drift.refits")
        return _fit.fit_traces(use, **fit_kw)

    def report(self) -> str:
        """Readable drift table (every key, flagged ones marked)."""
        lines = [f"drift watchdog: threshold x{self.threshold:.2f}, "
                 f"{len(self._cells)} keys, "
                 f"{sum(c.n for c in self._cells.values())} samples"]
        flagged = {(a.kind, a.axis, a.schedule, a.bucket)
                   for a in self.alerts()}
        for key in sorted(self._cells, key=str):
            kind, axis, schedule, bucket = key
            c = self._cells[key]
            mark = " <-- DRIFT" if key in flagged else ""
            lines.append(
                f"  {kind}@{axis or '-'}[{schedule or '-'}, "
                f"~2^{bucket}B]: x{c.ratio:.2f} (n={c.n}){mark}")
        for r, ratio, n in self.rank_alerts():
            lines.append(f"  rank {r}: x{ratio:.2g} vs peer median "
                         f"(n={n}) <-- {'DEAD?' if ratio < 1 else 'SICK'}")
        if flagged or self._rank_cells:
            verdict = self.classify()
            lines.append(f"  verdict: {verdict.describe()}")
            if verdict.verdict == "global":
                lines.append("  re-fit recommended "
                             "(repro_torch.tune.fit.fit_traces / "
                             "watchdog.refit())")
        return "\n".join(lines)
