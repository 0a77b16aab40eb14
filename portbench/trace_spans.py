"""Run one cell's traced part with the port's spans on, and print what
the spans read.

    python3 portbench/trace_spans.py --workload <cell> --seed <n> \\
        [--seconds 5] [--turns 3]

From the root of a checkout, on a card.  Set-up as ``run.py`` makes it;
a window of ``--seconds`` with the cell's own CUDA-event spans (as a
traced run's window); the first profiled pass exactly as ``--trace 1``
runs it, the program's spans off (``<cell>.trace.json``); then the same
steps or calls again under the port's span log
(:func:`portbench.harness.program.second_pass`,
``<cell>.program.trace.json``), and once more with the spans off.  What
spans cost is read twice: from the three profiled passes, and, before
any trace is read, from plain windows of ``--seconds`` as the benchmark
times its window, spans off and on in ``--turns`` turns.  Then the
check.  The last line of standard output is JSON: the cell's
per-layer metrics read from the first pass, the program-span metrics
(``harness/program.py`` ``READERS``) from the second, each pass's window,
busy and launches a step or call, the device and idle ms a step or call
by innermost span, the CUDA-event device ms of each span name a step or
call, each window's end-to-end metrics, and ``correct``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "portbench" / "out"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench.harness import compare, manifest, program, runner
    from repro_torch import obs

    cell = manifest.cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("trace_spans: needs a CUDA card", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    run = manifest.driver(cell.job["driver"]).Cell(cell, args.seed, "cuda")
    run.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    win = run.window(args.seconds, spans=True)
    windows = []
    for _ in range(args.turns):
        windows.append({"spans": False, **run.window(args.seconds)[
            "end_to_end"]})
        if hasattr(obs.spans, "span"):
            with obs.recording(spans=True):
                windows.append({"spans": True, **run.window(args.seconds)[
                    "end_to_end"]})
    prof = run.profile(OUT / f"{cell.name}.trace.json")
    prog = program.second_pass(run.profile,
                               OUT / f"{cell.name}.program.trace.json")
    keys = ("window_s", "busy_s", "ops", "count")
    passes = {"first": {k: prof[k] for k in keys}}
    if prog is not None:
        passes["second"] = prog["pass"]
        n = prog["pass"]["count"]
        passes["span_event_ms"] = {k: v / n for k, v in
                                   prog["span_device_ms"].items()}
    again = run.profile(None)
    passes["third"] = {k: again[k] for k in keys}
    record = dict(run.record(win, prof),
                  device_kind=torch.cuda.get_device_name(0), program=prog)
    first = {m["name"]: manifest.metric_reader(m["name"])(record)
             for m in cell.per_layer}
    second = {name: read(record) for name, read in program.READERS.items()}
    root = program.TRAIN_ROOT if "step_flops" in record \
        else program.SYNC_ROOT
    ok, table = compare.judge(run.check(), cell.job["limits"])
    print(json.dumps({
        "workload": cell.name, "seed": args.seed, "setup_s": setup_s,
        "device": runner.device_info("cuda", cell.chips)["kind"],
        "torch": torch.__version__, "correct": ok, "check": table,
        "metrics": first, "program_metrics": second, "passes": passes,
        "by_span": program.by_span(record, root), "windows": windows}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
