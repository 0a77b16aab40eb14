"""repro_torch's FaultPlan injection and drift-watchdog attribution against
the JAX reference's (``tests/test_faults.py``).

The same masked program runs on both simulators under the same
:class:`FaultPlan`: live-rank outputs are bitwise equal to the
reference's and to the port's executed masked program, every
``SimReport`` field (``rank_t_end`` included) is exactly the reference's
— the reference running with the port's placements, since its masked
pack falls back to the host (R1) — and the port's ``DriftWatchdog``
reaches the reference's verdict on the reports.
"""

import numpy as np
import pytest

from repro.cgra.simulate import FaultPlan as JFaultPlan
from repro.obs.drift import DriftWatchdog as JDriftWatchdog
from repro_torch.cgra.simulate import FaultPlan, SwitchSim
from repro_torch.obs import metrics as obs
from repro_torch.obs.drift import DriftWatchdog
from sim_parity import (assert_bitwise, assert_same_report, compile_pair,
                        executed, sim_pair)

N = 16
SIZE = 1 << 12


@pytest.fixture(scope="module")
def masked16():
    return compile_pair(
        lambda a: (lambda x, alive: a.masked_reduce(x, alive, axis="auto")),
        [(SIZE,), ()], N)


@pytest.fixture(scope="module")
def x16():
    return np.random.default_rng(0).standard_normal(
        (N, SIZE)).astype(np.float32)


def _plans(dead=(), timeout=0.0, **faults):
    kw = dict(dead=frozenset(dead), detect_timeout_s=timeout, **faults)
    tp, jp = FaultPlan(**kw), JFaultPlan(**kw)
    return (tp if tp else None), (jp if jp else None)


def _run(pair, x, dead=(), timeout=0.0, **faults):
    """Both simulators under one FaultPlan; the reports must agree
    exactly.  Returns the port's ``(outputs, report)``."""
    tc, jc = pair
    alive = np.ones((N,), np.float32)
    alive[list(dead)] = 0.0
    tp, jp = _plans(dead, timeout, **faults)
    (tout, trep), (jout, jrep), sim = sim_pair(tc, jc, [x, alive],
                                               faults=tp, jfaults=jp)
    for t, j in zip(tout, jout):
        assert_bitwise(t, j)
    assert_same_report(trep, jrep)
    return tout, trep, jrep, sim


# ---------------------------------------------------------------------------
# FaultPlan validation
# ---------------------------------------------------------------------------

def test_fault_plan_validation(masked16):
    tc, _ = masked16
    with pytest.raises(ValueError, match="k must be"):
        FaultPlan(degraded_links=(("data", 0.5),))
    with pytest.raises(ValueError, match="out of range"):
        SwitchSim(tc.topology, faults=FaultPlan(dead=frozenset({N})))
    with pytest.raises(ValueError, match="unknown axis"):
        SwitchSim(tc.topology,
                  faults=FaultPlan(degraded_links=(("ether", 2.0),)))
    assert not FaultPlan()          # empty plan is falsy (no-fault path)


# ---------------------------------------------------------------------------
# dead ranks: numerics stay correct, timing degrades linearly
# ---------------------------------------------------------------------------

def test_dead_ranks_keep_live_numerics_and_degrade_linearly(masked16, x16):
    _, rep0, _, _ = _run(masked16, x16)
    timeout = 0.25 * rep0.t_end
    ts = []
    tc, _ = masked16
    for k in (0, 1, 2, 4):
        dead = tuple(range(k))
        (v, cnt), rep, _, sim = _run(masked16, x16, dead=dead,
                                     timeout=timeout)
        live = np.ones(N, bool)
        live[list(dead)] = False
        np.testing.assert_allclose(v[N - 1].numpy(), x16[live].mean(0),
                                   atol=1e-5)
        assert cnt[N - 1].item() == N - k
        assert len(rep.rank_t_end) == N
        # the live ranks' outputs are the executed masked program's, bit
        # for bit (the fault plan changes timing, never the data path)
        alive = live.astype(np.float32)
        ev, ecnt = executed(tc, sim, [x16, alive])
        assert_bitwise(v[live], ev[live])
        assert_bitwise(cnt[live], ecnt[live])
        ts.append(rep.t_end)
    for a, b in zip(ts, ts[1:]):
        assert b >= a * 0.999, (ts,)          # monotone in failures
        assert b <= 2.0 * a, ("cliff", ts)    # linear-ish, never a cliff


def test_dead_ranks_counter(masked16, x16):
    with obs.recording() as rec:
        _run(masked16, x16, dead=(2, 9), timeout=1e-6)
    assert rec.counter("sim.dead_ranks") == 2


def test_straggler_and_degraded_link_slow_the_run(masked16, x16):
    _, rep0, _, _ = _run(masked16, x16)
    t0 = rep0.t_end
    _, rs, _, _ = _run(masked16, x16, straggler_s=((3, t0),))
    assert rs.t_end > t0
    assert rs.rank_t_end[3] >= max(                 # the straggler is last
        t for r, t in enumerate(rs.rank_t_end) if r != 3)
    _, rd, _, _ = _run(masked16, x16, degraded_links=(("data", 2.0),))
    assert rd.t_end > t0


# ---------------------------------------------------------------------------
# drift watchdog attribution over fault reports
# ---------------------------------------------------------------------------

def _hier_sync():
    pair = compile_pair(lambda a: (lambda x: a.reduce(x, axis="auto")),
                        [(SIZE,)], {"data": 4, "pod": 2},
                        backend="acis_hierarchical", outer="pod")
    x = np.arange(8 * SIZE, dtype=np.float32).reshape((4, 2, SIZE))
    return pair, x


def _watch(reports):
    """The port's and the reference's watchdogs fed the same reports."""
    twd, jwd = DriftWatchdog(), JDriftWatchdog()
    for trep, jrep in reports:
        assert twd.observe_report(trep) == jwd.observe_report(jrep)
    assert twd.ratios() == jwd.ratios()
    assert [a.describe() for a in twd.alerts()] == \
        [a.describe() for a in jwd.alerts()]
    assert twd.rank_alerts() == jwd.rank_alerts()
    tv, jv = twd.classify(), jwd.classify()
    assert (tv.verdict, tv.ranks, tv.axes, tv.ratio) == \
        (jv.verdict, jv.ranks, jv.axes, jv.ratio)
    # the text names its own package's fit module
    assert twd.report().replace("repro_torch.", "repro.") == jwd.report()
    return twd, tv


def _hier_reports(faults=None):
    (tc, jc), x = _hier_sync()
    tp = jp = None
    if faults:
        tp, jp = FaultPlan(**faults), JFaultPlan(**faults)
    out = []
    for _ in range(2):
        (_, trep), (_, jrep), _ = sim_pair(tc, jc, [x], faults=tp,
                                           jfaults=jp)
        assert_same_report(trep, jrep)
        out.append((trep, jrep))
    return out


def test_drift_quiet_on_faithful_replay():
    wd, verdict = _watch(_hier_reports())
    assert not wd.alerts() and not wd.rank_alerts()
    assert verdict.verdict == "quiet"
    assert not wd.refit_recommended()


def test_drift_attributes_dead_rank_locally(masked16, x16):
    """A dead rank reads as *that rank is sick* — mask it — not as a
    stale network model begging for a refit, in both packages."""
    reps = []
    for _ in range(2):
        _, trep, jrep, _ = _run(masked16, x16, dead=(5,), timeout=1e-5)
        reps.append((trep, jrep))
    wd, verdict = _watch(reps)
    assert verdict.verdict == "rank" and 5 in verdict.ranks
    assert verdict.local
    with obs.recording() as rec:
        assert not wd.refit_recommended()
    assert rec.counter("drift.rank_local") >= 1


def test_drift_attributes_degraded_link_locally():
    """A ×4 link on one tier drifts that axis's stage pools while the
    other tier stays quiet → link verdict, no refit."""
    wd, verdict = _watch(_hier_reports(
        {"degraded_links": (("data", 4.0),)}))
    assert verdict.verdict == "link", verdict
    assert "data" in verdict.axes and "pod" not in verdict.axes
    with obs.recording() as rec:
        assert not wd.refit_recommended()
    assert rec.counter("drift.link_local") >= 1
