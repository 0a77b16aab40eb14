"""Shared set-up of the benchmark's CPU tests: the checkout's root and
``src`` on the path, and a copy of the benchmark at smoke sizes."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# smoke sizes of every configuration: the families' structure at widths
# a CPU runs in seconds, float32 so that the program and the reference
# agree to float32 rounding
SMOKE = {"n_layers": 2, "d_model": 64, "n_heads": 4, "d_ff": 128,
         "vocab": 512, "max_seq": 64, "param_dtype": "float32",
         "dtype": "float32"}
SMOKE_JOB = {"rows_per_rank": 2, "seq": 16, "pool": 4}


def smoke_root(dest: Path) -> Path:
    """A copy of the checkout's benchmark under ``dest`` with every
    configuration and training job cut to smoke sizes (limits as
    committed)."""
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in man["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(SMOKE)
        cfg["n_kv_heads"] = 2 if cfg["family"] == "dense" else 4
        if cfg["family"] == "encdec":
            cfg["encdec"] = {"n_encoder_layers": 2, "encoder_seq": 16}
        path = dest / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    traffic = dest / "portbench" / "traffic"
    traffic.mkdir(parents=True, exist_ok=True)
    for p in (ROOT / "portbench" / "traffic").glob("*.json"):
        job = json.loads(p.read_text())
        if job["driver"] == "train":
            job.update(SMOKE_JOB)
        (traffic / p.name).write_text(json.dumps(job))
    (dest / "BENCHMARK.json").write_text(json.dumps(man))
    return dest


@pytest.fixture
def small(tmp_path) -> Path:
    return smoke_root(tmp_path)
