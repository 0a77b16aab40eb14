"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout.  Set-up (imports, the card, the kernels'
build, weights and batches made on the device, warm-up steps) is timed
from the start of this file; then the window runs for ``--seconds``;
with ``--trace 1`` a few more steps run under the profiler and the
per-layer metrics are printed instead of the end-to-end ones.  Last, the
program's state is freed and the plain reference checks what the timed
path produced: the numbers compared go to standard error, each beside
its limit, and into the result's ``check``.  The last line of standard
output is the result, JSON.  Without enough CUDA cards, with a module of
JAX or of the JAX package loaded, or on any error, the run exits non-zero
and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "portbench" / "out"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench.harness import manifest, runner

    cell = manifest.cell(args.workload, ROOT)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    result, lines = runner.run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), device="cuda",
                                    t0=T0, out_dir=OUT)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
