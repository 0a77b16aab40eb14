"""One run of one cell: set-up, the measured window, the traced part,
the check, and the result line, with the import guard after set-up,
after the window and once more just before the result is handed back.

The window driver (``drivers/<name>.py``) builds a ``Cell`` whose
``setup()`` builds the program's objects and warms up every shape the
window uses; ``window(seconds, spans)`` measures and returns
``{"attempted", "end_to_end": {name: value}, ...}``; ``profile(path)``
runs a few more calls under the profiler; ``check()`` frees the
program's state and compares what the timed path produced with the
reference.  ``record(win, prof)`` gives the per-layer readers what they read.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from portbench.harness import compare, guard, manifest


class ForbiddenModules(RuntimeError):
    pass


def _guard(when: str) -> None:
    bad = guard.loaded_forbidden()
    if bad:
        raise ForbiddenModules(f"{when}: the run loaded {bad}")


def device_info(device, chips: int) -> dict:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips}
    return {"platform": "cpu", "kind": "cpu", "count": chips}


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t0: float = None, out_dir: Path = None,
             bench: Path = manifest.BENCH) -> tuple[dict, list[str]]:
    """Returns (the result line's object, the check's lines for standard
    error)."""
    t0 = time.perf_counter() if t0 is None else t0
    cuda = torch.device(device).type == "cuda"
    drv = manifest.driver(cell.job["driver"], bench)
    run = drv.Cell(cell, seed, device)
    run.setup()
    _guard("after set-up")
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    win = run.window(seconds, spans=trace)
    dev = device_info(device, cell.chips)
    prof = None
    if trace:
        chrome = None if out_dir is None else \
            out_dir / f"{cell.name}.trace.json"
        prof = run.profile(chrome)
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
    _guard("after the window")
    if cuda:
        dev["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    record = dict(run.record(win, prof), device_kind=dev["kind"])
    t_check = time.perf_counter()
    numbers = run.check()
    check_s = time.perf_counter() - t_check
    ok, table = compare.judge(numbers, cell.job["limits"])
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"], bench)(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": win["end_to_end"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    result = {"correct": ok, "attempted": win["attempted"], "failed": 0,
              "metrics": metrics, "device": dev}
    if prof is not None:
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["check"] = table
    _guard("before the result")
    lines = [f"timing setup_s {setup_s!r} window_s {win['seconds']!r} "
             f"check_s {check_s!r}"]
    lines += [f"check {k} {r['value']!r} limit {r['limit']!r}"
             for k, r in table.items()]
    return result, lines
