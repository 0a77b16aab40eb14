#!/usr/bin/env python3
"""Count which path a training cell's attention takes on the card.

    python3 tools/attention_engaged.py --workload <cell> [<cell> ...] \\
        [--seed N]

From the root of a checkout, on a card.  Sets each benchmark cell up as
``portbench/run.py`` does, then runs its profiled steps once more under
the port's span log (``portbench.harness.program.second_pass``) and
prints one JSON line a cell: the counters ``kernel.attention.calls`` and
``attention.plain_calls`` (every ``flash_attention`` call on the card,
the remat's recomputed forward included), the kernel's share of them,
the kernel's forward and backward launches over the whole run, and every
counter of the pass (a MoE cell's ``moe.routed_pairs`` and
``moe.dropped_pairs`` among them).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=2900000001)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench.harness import manifest, program
    from repro_torch.kernels import flash_attention as FA

    if not torch.cuda.is_available():
        print("attention_engaged: needs a CUDA card", file=sys.stderr)
        return 3
    for name in args.workload:
        cell = manifest.cell(name, ROOT)
        run = manifest.driver(cell.job["driver"]).Cell(cell, args.seed,
                                                       "cuda")
        run.setup()
        with tempfile.TemporaryDirectory() as tmp:
            prog = program.second_pass(run.profile,
                                       Path(tmp) / "trace.json")
        kernel = prog["counters"].get("kernel.attention.calls", 0)
        plain = prog["counters"].get("attention.plain_calls", 0)
        print(json.dumps({
            "workload": name, "steps": prog["pass"]["count"],
            "kernel_calls": kernel, "plain_calls": plain,
            "share": kernel / (kernel + plain) if kernel + plain else None,
            "launches": {"forward": FA.launches,
                         "backward": FA.bwd_launches},
            "counters": prog["counters"],
            "card": torch.cuda.get_device_name(0)}), flush=True)
        run.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
