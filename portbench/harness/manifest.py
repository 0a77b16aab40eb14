"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names its configuration, whose
``file`` holds the model's sizes, and its traffic, a data file
``portbench/traffic/<traffic>.json`` holding the job: the window driver
(``portbench/drivers/<driver>.py``), the mesh, the engine, the batch and
the limits of the comparison.  A per-layer metric ``<name>`` is read by
``portbench/metrics/<name>.py``.  Adding a cell, a configuration or a
metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[2]
BENCH = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict              # the configuration file's contents
    job: dict              # the traffic file's contents, plus "ranks"
    end_to_end: list       # the end-to-end metrics it reports
    per_layer: list        # the per-layer metrics it reports


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s manifest; KeyError if there is
    none."""
    man = load(root)
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    job = json.loads((root / "portbench" / "traffic"
                      / f"{w['traffic']}.json").read_text())
    job["ranks"] = math.prod(job["mesh"].values())
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), cfg, job, e2e, per)


def _load(path: Path, tag: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        "portbench_" + tag + "_" + path.stem.replace(".", "_").replace(
            "-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, bench: Path = BENCH) -> ModuleType:
    return _load(bench / "drivers" / f"{name}.py", "driver")


def metric_reader(name: str, bench: Path = BENCH):
    """The ``read(record) -> float | None`` of the metric ``name``."""
    return _load(bench / "metrics" / f"{name}.py", "metric").read
