"""Read what the limits of a cell's comparison are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3

For every seed of ``--seeds`` the program's reading: set-up (a training
cell's checked steps; a sync cell's set-up and a short window), then the
numbers compared against the reference, as a run computes them (the
lower readings).  For every seed of ``--control-seeds`` also the
control and the faults a cell can have (``harness/faults.py``), planted
in the program: for training the control is the reference computed in
float8 e4m3 in the program's place, and the faults are ``half_batch``,
``no_exchange`` and ``one_rank`` (a state left unchanged reads 1 by
construction); for a sync the control is the float8 ring mean in the
sync's place, and the faults ``no_exchange`` (also a state left
unchanged), ``half_ranks`` and ``altered``.  One JSON line a reading on
standard output, and the same lines in ``--out``.  Needs a CUDA card, as
a run does.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worst_leaves(prog, ref) -> dict:
    """The three leaves that read worst in each by-leaf number."""
    from portbench.harness.compare import moved, norm_gaps

    out = {}
    for key, keep in (("grad_norms", None), ("update_norms", moved(ref))):
        g = norm_gaps(prog[key], ref[key], keep)
        out[key] = sorted(g.items(), key=lambda kv: -kv[1])[:3]
    return out


def _program(drv, cell, seed, fault=None):
    """A training cell's set-up, with ``fault`` planted: (its readings,
    set-up seconds)."""
    from portbench.harness import faults

    t = time.perf_counter()
    run = drv.Cell(cell, seed, "cuda")
    with faults.planted(fault) if fault else contextlib.nullcontext():
        run.setup()
    setup_s = time.perf_counter() - t
    readings = run.readings
    run.free()
    return readings, setup_s


def train_readings(drv, cell, seed, control: bool):
    from portbench.harness.compare import RankGradDiff, moved, train_numbers

    prog, setup_s = _program(drv, cell, seed)
    sets = {"program": prog}
    if control:
        for f in ("half_batch", "no_exchange", "one_rank"):
            sets["fault_" + f] = _program(drv, cell, seed, f)[0]
        run = drv.Cell(cell, seed, "cuda")
        ranks: list = [None] * cell.job["ranks"]

        def keep(r, grads):
            ranks[r] = {k: v.to("cpu") for k, v in grads.items()}
        sets["control_fp8"] = dict(run.reference(precision="fp8",
                                                 per_rank=keep),
                                   rank_grads=ranks)
    diffs = {k: RankGradDiff(v["rank_grads"]) for k, v in sets.items()}

    def judge(r, grads):
        for d in diffs.values():
            d(r, grads)
    t = time.perf_counter()
    ref = drv.Cell(cell, seed, "cuda").reference(per_rank=judge)
    ref_s = time.perf_counter() - t
    out = []
    for kind, rd in sets.items():
        rec = {"kind": kind, "numbers": train_numbers(rd, ref, diffs[kind]),
               "loss": rd["loss"], "worst": worst_leaves(rd, ref)}
        if kind == "program":
            rec.update(setup_s=setup_s, reference_s=ref_s,
                       ref_loss=ref["loss"],
                       left_out=sorted(set(ref["grad_norms"]) - moved(ref)))
        out.append(rec)
    return out


def sync_readings(drv, cell, seed, control: bool):
    from portbench.harness import faults

    out = []
    for kind in ("program",) + (faults.SYNC if control else ()):
        t = time.perf_counter()
        run = drv.Cell(cell, seed, "cuda")
        with faults.planted(kind) if kind != "program" \
                else contextlib.nullcontext():
            run.setup()
            setup_s = time.perf_counter() - t
            win = run.window(2.0)
        label = kind if kind in ("program", "control_fp8") \
            else "fault_" + kind
        out.append({"kind": label, "numbers": run.check(), "setup_s": setup_s,
                    "calls": win["calls"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench.harness import manifest

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    cell = manifest.cell(args.workload, ROOT)
    drv = manifest.driver(cell.job["driver"])
    read = train_readings if cell.job["driver"] == "train" \
        else sync_readings
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    try:
        for s in [int(s) for s in args.seeds.split(",")]:
            for rec in read(drv, cell, s, s in controls):
                line = json.dumps({"workload": args.workload, "seed": s,
                                   "device": torch.cuda.get_device_name(0),
                                   **rec})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
