"""BENCHMARK.json against the benchmark's contract, and the files the
harness finds by name (a cell added as files included)."""

import json
import re
import shutil

import pytest

from conftest import ROOT
from portbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    names = [m["name"] for m in metrics] + CELLS \
        + [c["name"] for c in MAN["configs"]]
    assert len(set(names)) == len(names)
    for n in names + [w["traffic"] for w in MAN["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [w["why"] for w in MAN["workloads"]] \
            + [c["why"] for c in MAN["configs"]] \
            + [c["source"] for c in MAN["configs"]] \
            + [m["layer"] for m in MAN["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert set(e2e) == {"train_tokens_per_s", "sync_ms", "sync_p95_ms",
                        "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_every_cell_reports_what_it_must():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for name in CELLS:
        cell = manifest.cell(name)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer and cell.chips == 1
        for m in cell.per_layer:
            assert m["moves"] in got and m["moves"] in e2e


def test_per_layer_entries_name_readers_and_layers():
    layers = {"train step", "model", "collective engine", "host dispatch",
              "kernels", "device"}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["layer"] in layers
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert callable(manifest.metric_reader(m["name"]))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_files_and_traffic():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    for c in MAN["configs"]:
        assert c["file"].startswith("portbench/") and c["reduced"] == []
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in MAN["workloads"]:
        job = manifest.cell(w["name"]).job
        assert (ROOT / "portbench" / "drivers" / f"{job['driver']}.py") \
            .is_file()
        assert job["limits"] and all(v > 0 for v in job["limits"].values())


def test_a_cell_added_as_files_is_found(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    job = json.loads((ROOT / "portbench" / "traffic"
                      / "train-int8hq.json").read_text())
    job["rows_per_rank"] = 2
    (tmp_path / "portbench" / "traffic" / "train-tiny.json").write_text(
        json.dumps(job))
    man["workloads"].append({"name": "acis-100m.train-tiny",
                             "config": "acis-100m", "traffic": "train-tiny",
                             "chips": 1, "why": "a test cell"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "acis-100m.train-int8hq" in m.get("workloads", ()):
            m["workloads"].append("acis-100m.train-tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = manifest.cell("acis-100m.train-tiny", tmp_path)
    assert cell.job["rows_per_rank"] == 2 and cell.job["ranks"] == 8
    assert cell.cfg["name"] == "acis-100m"
    assert {m["name"] for m in cell.end_to_end} == {"train_tokens_per_s",
                                                   "setup_s"}
    assert "mfu.train" in {m["name"] for m in cell.per_layer}
    assert hasattr(manifest.driver(cell.job["driver"],
                                   tmp_path / "portbench"), "Cell")
    with pytest.raises(KeyError):
        manifest.cell("acis-100m.nothing", tmp_path)
