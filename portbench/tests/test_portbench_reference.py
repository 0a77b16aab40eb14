"""The plain reference against the port at smoke sizes on the CPU, and
whole runs of every cell there (the look for a card skipped): sound,
with each fault a cell can have planted in the timed path, and with the
control (the reference in float8) in the program's place."""

import json

import pytest
import torch

from conftest import ROOT
from portbench.drivers import train as train_driver
from portbench.harness import (faults, guard, manifest, runner, traffic,
                               weights)
from portbench.reference import model as ref_model
from portbench.reference.spec import param_spec
from portbench.reference.train import int8_roundtrip

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json")
                                       .read_text())["workloads"]]
TRAIN = [c for c in CELLS if ".train-" in c]
SYNC = [c for c in CELLS if ".sync-" in c]


def run(root, name, seed=2 ** 33 + 5):
    cell = manifest.cell(name, root)
    return runner.run_cell(cell, seed, 0.2, False, device="cpu")[0]


@pytest.mark.parametrize("config", ["acis-100m", "whisper-small"])
def test_reference_logits_match_the_port(small, config):
    from repro_torch.models import Model

    cfg = json.loads((small / "portbench" / "configs"
                      / f"{config}.json").read_text())
    model = Model(train_driver.program_config(cfg))
    flat = weights.draw(param_spec(cfg), 11, "cpu")
    params = weights.nest(flat, model.param_shapes())
    job = {"ranks": 1, "rows_per_rank": 3, "seq": 12, "pool": 1,
           "branching": 8}
    batch = traffic.train_pool(cfg, job, 11, "cpu")[0]
    ctx = batch["context"]
    hidden, _ = model.forward(params, batch["tokens"][:, :-1],
                              context=None if ctx is None else ctx.float())
    got = model.logits(params, hidden)
    W = {k: v.float() for k, v in flat.items()}
    mm = ref_model.matmul("float32")
    want = mm(ref_model.hidden(W, cfg, batch["tokens"][:, :-1],
                               None if ctx is None else ctx.float(), mm),
              ref_model.head(W, cfg))
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_int8_roundtrip_matches_the_port_codec():
    from repro_torch.core.wire import dequantize_int8, quantize_int8

    x = torch.randn(3, 1000, generator=torch.Generator().manual_seed(4))
    q, s, n = quantize_int8(x.reshape(-1))
    got = dequantize_int8(q, s, n).reshape(x.shape)
    assert torch.equal(int8_roundtrip(x), got)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small, name):
    out = run(small, name)
    assert out["correct"], out["check"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert "setup_s" in out["metrics"]
    assert list(out)[-1] == "check"
    assert guard.loaded_forbidden() == []


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_exchange",
                                   "one_rank"])
def test_train_faults_come_out_not_correct(small, name, fault):
    with faults.planted(fault):
        out = run(small, name)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("name", SYNC)
@pytest.mark.parametrize("fault", ["no_exchange", "half_ranks", "altered"])
def test_sync_faults_come_out_not_correct(small, name, fault):
    with faults.planted(fault):
        out = run(small, name)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("name", TRAIN)
def test_train_control_comes_out_not_correct(small, monkeypatch, name):
    """The reference in float8 put in the program's place: its readings
    of the checked steps are what the run compares."""
    def setup(self):
        ranks = [None] * self.job["ranks"]

        def keep(r, grads):
            ranks[r] = grads
        self.readings = dict(self.reference(precision="fp8", per_rank=keep),
                             rank_grads=ranks)
        self.pool = traffic.train_pool(self.cfg, self.job, self.seed,
                                       self.device)
    monkeypatch.setattr(train_driver.Cell, "setup", setup)
    monkeypatch.setattr(train_driver.Cell, "window", lambda self, s, spans:
                        {"attempted": 1, "seconds": s, "end_to_end": {
                            "train_tokens_per_s": 1.0}})
    monkeypatch.setattr(manifest, "driver", lambda name, bench=None:
                        train_driver)
    out = run(small, name)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("name", SYNC)
def test_sync_control_comes_out_not_correct(small, name):
    with faults.planted("control_fp8"):
        out = run(small, name)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("when", ["before", "in_check"])
def test_a_forbidden_module_stops_the_run(small, monkeypatch, when):
    """Loaded before the run, or only while the check runs: either way
    no result comes back."""
    import sys
    import types

    from portbench.drivers import sync as sync_driver

    if when == "before":
        monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    else:
        real = sync_driver.Cell.check

        def check(self):
            sys.modules["repro"] = types.ModuleType("repro")
            return real(self)
        monkeypatch.setattr(sync_driver.Cell, "check", check)
        monkeypatch.setattr(manifest, "driver", lambda name, bench=None:
                            sync_driver)
    try:
        with pytest.raises(runner.ForbiddenModules):
            run(small, SYNC[0])
    finally:
        sys.modules.pop("repro", None)


def test_guard_compares_whole_top_level_names():
    assert guard.loaded_forbidden(["repro_torch.core.api", "reprox"]) == []
    assert guard.loaded_forbidden(["repro.core", "jax.numpy",
                                   "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]
