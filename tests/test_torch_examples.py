"""The port's examples (``examples/torch_*.py``) against the reference's.

Each twin's ``main`` runs on the CPU (``device="cpu"``; ``--smoke`` where
the example builds a model) beside the reference example's ``main`` on
the same seeded numpy input.  The reference example prints and returns
nothing, so its module's globals are wrapped (:class:`Through`,
:func:`logged`) to log what its calls return; ``src/repro`` and the
reference example are untouched.  This file holds the collective demos;
``tests/test_torch_examples_models.py`` the two that build a model.
Compared, each with its reason:

* compiled stage names, and ``explain()``'s kind, axis, schedule and
  codec columns row for row.  Placements are not compared (R1: jax's
  nested ``jit`` hides the int8 stages from the reference's mapper,
  which falls back to the host where the port's ``make_fx`` mapper
  places them); the tests name that divergence where it shows.
* Fig. 5 on its integer input bitwise; on random floats within 1e-5 of
  the largest magnitude (a float scan adds in each package's order).
* the Welford mean and variance, the hierarchical sync, the EF and
  PowerSGD results, the collective matmul: within 1e-5 of each one's
  largest magnitude; the EF residual within 1e-5 of the largest input
  (XLA's reciprocal multiply moves the int8 scale by an ulp).  The
  printed lines, the bf16 ring, the max reduce and the traced DAG's
  outputs: equal.
* ``SwitchSim``: every ``SimReport`` field equal, the reference run on a
  copy of its program carrying the port's placements
  (``tests/sim_parity.py``).
"""

import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import core as jacis
from repro.cgra.simulate import SwitchSim as JSim

import sim_parity

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
TWINS = ("quickstart", "fused_collectives", "hierarchical_sync",
         "cgra_simulate", "serve_batched", "train_e2e")


def load(name: str):
    """``examples/<name>.py`` as a fresh module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


class Through:
    """Stands in for ``target``: the keyword attributes replace its own,
    every other attribute read passes through."""

    def __init__(self, target, **over):
        self._target = target
        self.__dict__.update(over)

    def __getattr__(self, name):
        return getattr(self._target, name)


def logged(fn, log: list):
    """``fn``, each call's result appended to ``log``; attribute reads
    (a compiled program's ``stages``) pass through."""
    class Logged:
        def __call__(self, *args, **kw):
            out = fn(*args, **kw)
            log.append(out)
            return out

        def __getattr__(self, name):
            return getattr(fn, name)

    return Logged()


def logging_jax(log: list) -> Through:
    """``jax`` whose ``jit``-ed functions log their results."""
    return Through(jax, jit=lambda f, **kw: logged(jax.jit(f, **kw), log))


def logging_acis(programs: list, outs=None) -> Through:
    """The reference's ``core`` whose engines log each compiled program
    (in ``programs``) and, given ``outs``, its calls' results."""
    def make_engine(*args, **kw):
        eng = jacis.make_engine(*args, **kw)

        def compile(*cargs, **ckw):
            prog = eng.compile(*cargs, **ckw)
            programs.append(prog)
            return prog if outs is None else logged(prog, outs)
        return Through(eng, compile=compile)
    return Through(jacis, make_engine=make_engine)


def rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return float(np.abs(got.astype(np.float64) - want).max()
                 / np.abs(want).max())


def bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def explain_rows(text: str) -> list[list[str]]:
    """Every stage row of every ``explain()`` table in ``text``: its #,
    wave, kind, axis, schedule and codec columns, and the placement."""
    rows, inside = [], False
    for line in text.splitlines():
        cols = re.split(r"\s{2,}", line.strip())
        if cols[:2] == ["#", "wave"]:
            inside = True
        elif inside and cols[0].isdigit() and len(cols) >= 7:
            rows.append(cols[:6] + [" ".join(cols[6:])])
        elif inside and not line.lstrip().startswith("-"):
            inside = False
    return rows


def columns(text: str) -> list[list[str]]:
    return [r[:6] for r in explain_rows(text)]


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TWINS)
def test_twin_runs_on_the_card_by_default(name):
    """Run as a script a twin takes the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    twin = load(f"torch_{name}")
    argv = ["--smoke"] if name in ("quickstart", "serve_batched",
                                   "train_e2e") else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        twin.main(argv)


def test_quickstart_matches_reference(capsys):
    jit_outs, progs, prog_outs = [], [], []
    ref = load("quickstart")
    ref.jax = logging_jax(jit_outs)
    ref.acis = logging_acis(progs, prog_outs)
    ref.main()
    capsys.readouterr()
    got = load("torch_quickstart").main(["--smoke"], device="cpu")

    assert got["fig5_stages"] == list(progs[0].stages) == ["scan+allgather"]
    bitwise(got["fig5_out"], prog_outs[0])          # integers: exact
    assert got["nas_is_stages"] == list(progs[1].stages) \
        == ["allreduce+alltoall"]
    jh, jk = prog_outs[1]
    bitwise(got["hist"], jh)
    bitwise(got["keys"], jk)
    assert got["hist_sum"] == float(jh[0, 0]) == 8.0
    jmean, jvar = jit_outs[0]
    assert rel(got["welford_mean"], jmean) <= 1e-5
    assert rel(got["welford_var"], jvar) <= 1e-5
    hidden, _ = jit_outs[1]
    assert got["hidden_shape"] == hidden.shape and got["hidden_finite"]


def test_fused_collectives_matches_reference(capsys):
    outs, progs, prog_outs = [], [], []
    ref = load("fused_collectives")
    ref.jax = logging_jax(outs)
    ref.acis = logging_acis(progs, prog_outs)
    ref.main()
    want = capsys.readouterr().out.splitlines()
    got = load("torch_fused_collectives").main([], device="cpu")
    assert capsys.readouterr().out.splitlines() == want   # every number
    bf16, mx, (red, res), psgd, fem, mm = outs
    bitwise(got["bf16_out"], bf16)
    bitwise(got["max_out"], mx)
    assert rel(got["ef_reduced"], red) <= 1e-5
    # a residual is the target less what the wire delivered: its error is
    # the scale's (XLA multiplies absmax by 1/127 where the port divides,
    # an ulp of the scale times q), held to the target's magnitude
    x = got["x"].numpy()
    assert np.abs(got["ef_residual"].numpy() - np.asarray(res)).max() \
        <= 1e-5 * np.abs(x).max()
    assert rel(got["powersgd"], psgd) <= 1e-5
    assert rel(got["fused_out"], fem) <= 1e-5
    assert rel(got["matmul_out"], mm) <= 1e-5
    (prog,) = progs
    assert got["dag_stages"] == list(prog.stages)
    assert got["dag_schedules"] == [s or "-" for s in prog.schedules]
    bitwise(got["dag_hist"], prog_outs[0][0])
    bitwise(got["dag_keys"], prog_outs[0][1])


def test_hierarchical_sync_matches_reference(capsys):
    outs, progs = [], []
    ref = load("hierarchical_sync")
    ref.jax = logging_jax(outs)
    ref.acis = logging_acis(progs)
    ref.main()
    want = capsys.readouterr().out
    got = load("torch_hierarchical_sync").main([], device="cpu")
    text = capsys.readouterr().out
    assert columns(text) == columns(want)
    assert len(columns(text)) == 10                 # 5 stages, 2 programs
    for line in ("wire codec on the inter-pod hop: identity",
                 "wire codec on the inter-pod hop: int8_b256"):
        assert line in text and line in want
    # R1, named: the reference falls back to the host for the int8 pod
    # hop, the port's mapper places it
    ref_pod, port_pod = explain_rows(want)[7][6], explain_rows(text)[7][6]
    assert ref_pod.startswith("host-fallback") and "primitive 'jit'" \
        in ref_pod
    assert "PEs" in port_pod and not port_pod.startswith("host-fallback")
    for (b, p), jc in zip(got["programs"].items(), progs):
        assert p["stages"] == jc.stage_kinds()
    (synced,) = outs
    assert rel(got["synced"], synced) <= 1e-5
    assert got["sync_err"] <= 1e-6
    assert f"compiled sync stages: {got['sync_stages']}" in want


def test_cgra_simulate_matches_reference(capsys):
    runs, progs = [], []

    class LoggedSim(JSim):
        def run(self, compiled, *xs):
            runs.append((self, compiled, xs))
            return super().run(compiled, *xs)

    ref = load("cgra_simulate")
    ref.SwitchSim = LoggedSim
    ref.acis = logging_acis(progs)
    ref.main()
    want = capsys.readouterr().out
    got = load("torch_cgra_simulate").main([], device="cpu")
    text = capsys.readouterr().out
    assert columns(text) == columns(want)
    # R1, named: the reference's int8 EF stage and int8 pod hop fall back
    # to the host, the port places them; top-k falls back in both
    assert "ef_reduce[int8]: host-fallback" in want
    assert not got["int8"]["placement"].startswith("host-fallback")
    assert got["topk"]["placement"].startswith("host-fallback: top-k")
    for key, (sim, jc, xs) in zip(("fig5", "int8", "topk", "hierarchical"),
                                  runs):
        tc = got[key]["program"]
        assert tc.stage_kinds() == jc.stage_kinds()
        jout, jrep = JSim(jc.topology).run(
            sim_parity.with_port_placements(jc, tc), *xs)
        sim_parity.assert_same_report(got[key]["report"], jrep)
        if "out" in got[key]:
            assert rel(got[key]["out"], jout) <= 1e-5
    assert got["fig5"]["err_f64"] <= 1e-5 * np.abs(
        np.cumsum(got["fig5"]["input"].reshape(-1))).max()
