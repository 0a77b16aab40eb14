"""Fit :class:`~repro_torch.core.netmodel.NetParams` from recorded traces.

Every ring-schedule stage time is linear in the link unknowns
(:class:`repro_torch.core.netmodel.StageTerms`)::

    t = hops·hop_T + wire_bytes·(1/bw_T) + detours·D + host_bytes·(1/hbw)
        + [compute and mpi terms charged at their priors]

with per-tier unknowns ``hop_T`` (= fpga_link + port) and ``1/bw_T``,
plus two global host-fallback unknowns: the detour constant ``D``
(= 2·pcie + mpi_overhead) and the endpoint stream rate ``1/host_bw``.
:func:`fit_net_params` solves the normal equations of that design over
every recorded stage, with the same drop-and-resolve degeneracy handling
as :func:`repro_torch.core.netmodel.fit_tier_overlap`: a column with no
support, or (nearly) collinear with the others, is unidentifiable from
these traces — it keeps its prior and the system is re-solved without
it, so the returned fit stays consistent with the equations it came
from.

:func:`fit_traces` then re-runs ``fit_tier_overlap`` on the whole-program
end-to-end times *under the fitted tiers* — the per-tier exposure
decomposition ``netmodel._wave_terms`` exposes makes the overlap
fractions one more linear special case of the same machinery.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core import netmodel


class TunedTopology:
    """A topology view whose per-axis link parameters come from a fit.

    Duck-types :class:`repro_torch.core.compiler.Topology` for everything the
    cost model and the simulator read (``axes``/``spec``/``size``/
    ``net``), but resolves ``net(axis)`` through ``{tier: NetParams}``
    instead of the global :data:`repro_torch.core.netmodel.TIERS` constants —
    so fitted parameters flow into ``plan_stage_time``/``program_time``
    without mutating module state.
    """

    def __init__(self, topo, tiers: dict):
        self._topo = topo
        self._tiers = dict(tiers)

    @property
    def axes(self):
        return self._topo.axes

    def names(self):
        return self._topo.names()

    def spec(self, name):
        return self._topo.spec(name)

    def size(self, name):
        return self._topo.size(name)

    def net(self, name) -> netmodel.NetParams:
        spec = self._topo.spec(name)
        tier = spec.tier if spec is not None else "ici"
        return self._tiers.get(tier, self._topo.net(name))

    def with_sizes(self, sizes: dict) -> "TunedTopology":
        return TunedTopology(self._topo.with_sizes(sizes), self._tiers)


@dataclasses.dataclass(frozen=True)
class NetFit:
    """A fitted network model: per-tier link params + overlap fractions.

    ``dropped`` names the unidentifiable columns left at their priors
    (e.g. ``"dci.hop"`` when no trace stage ever crossed the dci tier);
    ``residual`` is the rms relative error of the fitted per-stage times
    over the stages that entered the design.
    """

    tiers: dict                    # tier name → NetParams
    overlap: dict                  # tier name → overlap fraction
    detour: float                  # fitted 2·pcie + mpi_overhead (s)
    host_bw: float                 # fitted endpoint stream rate (B/s)
    residual: float = 0.0
    n_stages: int = 0
    dropped: tuple = ()

    def wrap(self, topo) -> TunedTopology:
        """``topo`` with this fit's per-tier link parameters."""
        return TunedTopology(topo, self.tiers)

    def params(self, tier: str = "ici") -> netmodel.NetParams:
        return self.tiers.get(tier, netmodel.PAPER)

    def program_time(self, plan, topo) -> float:
        """:func:`repro_torch.core.netmodel.program_time` under this fit."""
        return netmodel.program_time(plan, self.wrap(topo),
                                     self.params(), overlap=self.overlap)


def _stage_rows(samples, tiers: Sequence[str]):
    """(coeff_vector, residual_target, rel_scale) per usable stage.

    Columns: ``[hop_T, invbw_T] * tiers + [detour, inv_host_bw]``.  The
    compute and extra-mpi terms are charged at their prior rates and
    subtracted from the measured time — the CGRA device and the software
    stack are not what the wire fit estimates.
    """
    cols = [f"{t}.{u}" for t in tiers for u in ("hop", "invbw")]
    cols += ["host.detour", "host.invbw"]
    rows = []
    for plan, topo, trace in samples:
        stages = getattr(trace, "stages", trace)
        for ts in stages:
            i = ts.stage
            if not 0 <= i < len(plan.stages):
                continue
            st = plan.stages[i]
            if st.kind != ts.kind:
                continue
            got = netmodel.plan_stage_terms(st, topo)
            if got is None:
                continue
            tier, terms, placement = got
            p_prior = topo.net(st.axis) if st.axis else netmodel.PAPER
            fixed = 0.0
            if terms.compute_bytes:
                fixed += terms.compute_bytes / netmodel.accel_rate(
                    p_prior, placement)
            fixed += terms.mpi_msgs * p_prior.mpi_overhead
            coeff = [0.0] * len(cols)
            if tier in tiers:
                base = 2 * tiers.index(tier)
                coeff[base] = terms.hops
                coeff[base + 1] = terms.wire_bytes
            elif terms.hops or terms.wire_bytes:
                # a tier outside the fit keeps its prior wire cost
                fixed += terms.hops * (p_prior.fpga_link + p_prior.port) \
                    + terms.wire_bytes / p_prior.bw
            coeff[-2] = terms.detours
            coeff[-1] = terms.host_bytes
            if not any(coeff):
                continue
            rows.append((coeff, ts.duration - fixed, max(ts.duration,
                                                         1e-12)))
    return cols, rows


def _solve_dropping(cols, rows, priors):
    """Normal-equations solve with fit_tier_overlap's drop-and-resolve:
    columns without support or collinear with the rest fall back to their
    prior value and the system is re-solved without them."""
    live = list(range(len(cols)))
    while True:
        k = len(live)
        if k == 0:
            return dict(priors), tuple(cols)
        gram = [[0.0] * k for _ in range(k)]
        rhs = [0.0] * k
        for coeff, target, _ in rows:
            r = target - sum(coeff[j] * priors[cols[j]]
                             for j in range(len(cols)) if j not in live)
            for a in range(k):
                ca = coeff[live[a]]
                if not ca:
                    continue
                rhs[a] += ca * r
                for b in range(k):
                    gram[a][b] += ca * coeff[live[b]]
        dead = next((j for a, j in enumerate(live)
                     if gram[a][a] <= 0.0), None)
        a_mat = None
        if dead is None:
            a_mat = [row[:] + [rhs[a]] for a, row in enumerate(gram)]
            for col in range(k):
                piv = max(range(col, k), key=lambda r_: abs(a_mat[r_][col]))
                scale = max(abs(gram[col][col]), 1e-30)
                if abs(a_mat[piv][col]) < 1e-9 * scale:
                    dead = live[col]
                    break
                a_mat[col], a_mat[piv] = a_mat[piv], a_mat[col]
                for r_ in range(k):
                    if r_ != col and a_mat[r_][col]:
                        f = a_mat[r_][col] / a_mat[col][col]
                        a_mat[r_] = [x - f * y
                                     for x, y in zip(a_mat[r_], a_mat[col])]
        if dead is not None:
            live.remove(dead)
            continue
        fitted = dict(priors)
        for a, j in enumerate(live):
            fitted[cols[j]] = max(a_mat[a][-1] / a_mat[a][a], 0.0)
        dropped = tuple(cols[j] for j in range(len(cols))
                        if j not in live)
        return fitted, dropped


def fit_net_params(samples, *, tiers: Sequence[str] = ("ici", "dci"),
                   p: netmodel.NetParams = netmodel.PAPER) -> NetFit:
    """Least-squares :class:`NetFit` (link params only; overlap fractions
    stay at :data:`~repro_torch.core.netmodel.TIER_OVERLAP` — use
    :func:`fit_traces` for the full fit).

    ``samples`` is an iterable of ``(plan, topo, trace)`` where ``trace``
    is a :class:`~repro_torch.tune.trace.ProgramTrace` (or bare list of
    :class:`~repro_torch.tune.trace.StageTrace`) recorded from that plan.
    """
    samples = list(samples)
    tiers = tuple(tiers)
    cols, rows = _stage_rows(samples, tiers)
    priors = {}
    for t in tiers:
        tp = netmodel.TIERS.get(t, p)
        priors[f"{t}.hop"] = tp.fpga_link + tp.port
        priors[f"{t}.invbw"] = 1.0 / tp.bw
    priors["host.detour"] = 2 * p.pcie + p.mpi_overhead
    priors["host.invbw"] = 1.0 / p.host_bw
    fitted, dropped = _solve_dropping(cols, rows, priors)

    detour = fitted["host.detour"]
    host_bw = 1.0 / max(fitted["host.invbw"], 1e-30)
    tier_params = {}
    for t in tiers:
        prior_t = netmodel.TIERS.get(t, p)
        hop = fitted[f"{t}.hop"]
        tier_params[t] = dataclasses.replace(
            prior_t,
            fpga_link=max(hop - prior_t.port, 0.0),
            bw=1.0 / max(fitted[f"{t}.invbw"], 1e-30),
            mpi_overhead=max(detour - 2 * p.pcie, 0.0),
            host_bw=host_bw)

    # rms relative residual of the fitted per-stage times
    err2, n_used = 0.0, 0
    for coeff, target, scale in rows:
        pred = sum(c * fitted[cols[j]] for j, c in enumerate(coeff))
        err2 += ((pred - target) / scale) ** 2
        n_used += 1
    residual = math.sqrt(err2 / n_used) if n_used else 0.0

    return NetFit(tiers=tier_params, overlap=dict(netmodel.TIER_OVERLAP),
                  detour=detour, host_bw=host_bw, residual=residual,
                  n_stages=n_used, dropped=dropped)


def fit_overlap(samples, fit: NetFit, *,
                tiers: Sequence[str] = ("ici", "dci")) -> dict:
    """:func:`repro_torch.core.netmodel.fit_tier_overlap` under fitted link
    parameters — the special case the full fit reduces to once the
    per-stage times are pinned.  ``samples`` as in :func:`fit_net_params`
    (whole-program ``trace.t_end`` is the measurement)."""
    wrapped = [(plan, fit.wrap(topo), getattr(trace, "t_end", trace))
               for plan, topo, trace in samples]
    return netmodel.fit_tier_overlap(wrapped, tiers=tuple(tiers),
                                     p=fit.params())


def fit_traces(samples, *, tiers: Sequence[str] = ("ici", "dci"),
               p: netmodel.NetParams = netmodel.PAPER,
               overlap: bool = True) -> NetFit:
    """The full fit: link parameters from per-stage durations, then the
    per-tier overlap fractions from the end-to-end times under those
    parameters.  Multi-axis samples identify the overlap; single-axis
    samples leave it at the calibrated default (drop-and-resolve)."""
    samples = list(samples)
    fit = fit_net_params(samples, tiers=tiers, p=p)
    if overlap:
        fit = dataclasses.replace(
            fit, overlap={**fit.overlap,
                          **fit_overlap(samples, fit, tiers=tiers)})
    from repro_torch.obs import metrics as _obs
    _obs.RECORDER.event("tune.fit", residual=fit.residual,
                        n_stages=fit.n_stages, dropped=fit.dropped)
    return fit
