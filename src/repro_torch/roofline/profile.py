"""Dry-run "profiler": one cell's collectives ranked by bytes.

    PYTHONPATH=src python -m repro_torch.roofline.profile --arch rwkv6-1.6b \\
        --shape train_4k [--probe] [--extra '{"parallelism":"pure_dp"}']

The port of :mod:`repro.roofline.profile`.  The reference ranks the
collective ops of a cell's compiled HLO; here they come from the native
collective log of the cell's run on the meta device
(:mod:`repro_torch.sharding.native`): each with its kind, its forward or
backward origin, its axes and per-rank bytes, plus the repeat counts of
identical collectives (one a layer and microbatch is the signal of a
per-layer gather).
"""

from __future__ import annotations

import argparse
import json
from collections import Counter


def profile_log(log, top: int = 15) -> dict:
    """The log's collectives ranked by per-rank bytes."""
    rows = sorted(((e.bytes, e.kind, e.direction, e.axes, e.out_shape,
                    e.dtype) for e in log.entries), key=lambda r: -r[0])
    stems = Counter((r[1], r[2], r[3], r[4]) for r in rows)
    by_origin: dict = {}
    for b, kind, direction, *_ in rows:
        k = f"{kind}/{direction}"
        by_origin[k] = by_origin.get(k, 0) + b
    return {"total_bytes": sum(r[0] for r in rows), "count": len(rows),
            "by_origin": dict(sorted(by_origin.items())),
            "top": rows[:top],
            "dup_stems": [[list(k), n] for k, n in stems.most_common(5)]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--probe", action="store_true",
                    help="profile the (1,1) probe instead of the full cell")
    ap.add_argument("--extra", default=None)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_production_mesh

    extra = json.loads(args.extra) if args.extra else None
    mesh = make_production_mesh()
    if args.probe:
        built = cells.build_probe(args.arch, args.shape, mesh, periods=1,
                                  microbatches=1, extra_config=extra)
    else:
        built = cells.build_cell(args.arch, args.shape, mesh,
                                 extra_config=extra)
    prof = profile_log(built.log, args.top)
    print(f"collective ops: {prof['count']}, total "
          f"{prof['total_bytes'] / 2**30:.3f} GiB/rank")
    for origin, b in prof["by_origin"].items():
        print(f"  {origin:22s} {b / 2**20:12.1f} MiB")
    for b, kind, direction, axes, shape, dtype in prof["top"]:
        print(f"{b / 2**20:9.1f}MiB {kind:15s} {direction} {axes} "
              f"{list(shape)} {dtype}")


if __name__ == "__main__":
    main()
