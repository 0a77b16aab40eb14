"""Multi-pod dry run: every (arch × shape) built on the production meshes
on the meta device, with its memory, cost and collective counts.

    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k \\
        --multi-pod
    python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
        [--single-pod-only] [--jobs N]

The port of :mod:`repro.launch.dryrun`.  It runs on the CPU and needs no
card: each cell's program runs on meta tensors
(:mod:`repro_torch.launch.cells`).  Single-cell mode builds the whole
cell (its per-rank argument, output and peak live bytes, which the
record keeps as ``memory_analysis``) and, on the single-pod mesh, the
four linear probes whose composition gives the roofline record
(:mod:`repro_torch.roofline.analysis`, against one H100's published
peaks).  ``--all`` runs each cell in its own subprocess (``--jobs`` at a
time) so one pathological cell cannot take down the sweep, and writes
``summary.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback


# what memory_analysis measures, kept in every record
MEMORY_NOTE = ("per rank, of the port's eager program on meta tensors: "
               "the stacked layers gathered one period at a time, expert "
               "banks stored expert-parallel kept so, every other leaf "
               "gathered whole over 'model'. A train step under remat "
               "full or dots gathers a period again in its recompute; "
               "under remat none it keeps every period's gathered "
               "weights for the backward. Not XLA's buffer assignment: "
               "read it as the port's footprint, not as a fit test of "
               "the reference's program")


def run_cell(arch: str, shape: str, multi_pod: bool, out_path=None, *,
             microbatches=None, remat=None, skip_probes=False,
             extra_config=None) -> dict:
    from repro_torch import configs as cfgs
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.roofline import analysis

    # ---- 1. the whole cell: the layout holds at 256 / 512 ranks, and
    # its memory
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    built = cells.build_cell(arch, shape, mesh, microbatches=microbatches,
                             remat=remat, extra_config=extra_config)
    t_build = time.time() - t0
    mem = built.memory
    print(f"== {arch} × {shape} × {built.mesh_desc} ==")
    print("memory_analysis (per rank):", mem)
    print("counts (whole cell, per rank): flops={flops:.3e} "
          "bytes={b:.3e} coll={c:.3e}".format(
              flops=built.counts["flops"], b=built.counts["hbm_bytes"],
              c=built.counts["coll_bytes"]))
    record: dict = {
        "arch": arch, "shape": shape, "mesh": built.mesh_desc,
        "multi_pod": multi_pod, "build_s": round(t_build, 2),
        "memory_analysis": {
            "temp_bytes": mem["temp_bytes"],
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "alias_bytes": mem["alias_bytes"],
            "note": MEMORY_NOTE,
        },
        "whole_cell_counts": {k: built.counts[k] for k in
                              ("flops", "hbm_bytes", "coll_bytes")},
        "tp_plan": {"attention": built.tp_plan[0],
                    "ffn": built.tp_plan[1]},
        "activation_pins": built.act,
        "status": "ok",
    }

    # ---- 2. linear probes: the roofline counts at a fraction of the
    # dispatch (single-pod only: the roofline table is single-pod)
    if not multi_pod and not skip_probes:
        cfg = cfgs.get(arch)
        plen, rlen, n_periods = cells.probe_layer_counts(cfg)
        kind = SHAPES[shape].kind
        mb_cell = (microbatches or cells.TRAIN_MICROBATCHES.get(
            arch, cells.TRAIN_MICROBATCHES["default"])) \
            if kind == "train" else 1
        ladder = [(1, 1), (2, 1)] + ([(1, 2), (2, 2)]
                                     if kind == "train" else [])
        costs = {}
        for periods, mb in ladder:
            tp = time.time()
            probe = cells.build_probe(arch, shape, mesh, periods=periods,
                                      microbatches=mb,
                                      extra_config=extra_config)
            costs[(periods, mb)] = cells.probe_costs(probe)
            print(f"probe(p={periods}, mb={mb}): "
                  f"flops={costs[(periods, mb)]['flops']:.3e} "
                  f"({time.time() - tp:.1f}s)")
            del probe
        composed = cells.compose_probe_costs(
            costs, n_periods=n_periods, mb_cell=mb_cell, kind=kind)
        roof = analysis.Roofline(
            arch=arch, shape=shape, mesh=built.mesh_desc, chips=mesh.n_ranks,
            flops=composed["flops"], hbm_bytes=composed["hbm_bytes"],
            coll_bytes=composed["coll_bytes"],
            coll_detail={"probe_raw": {f"{p}x{m}": c
                                       for (p, m), c in costs.items()}},
            model_flops=analysis.model_flops_for(arch, shape),
            per_device_bytes=mem["temp_bytes"] + mem["argument_bytes"]
            + mem["output_bytes"] - mem["alias_bytes"])
        record.update(roof.to_dict())
        record["probe_composition"] = {
            "n_periods": n_periods, "period_len": plen, "rem_len": rlen,
            "mb_cell": mb_cell}
        print(f"bottleneck={record['bottleneck']} "
              f"t_comp={record['t_compute_s']:.4f}s "
              f"t_mem={record['t_memory_s']:.4f}s "
              f"t_coll={record['t_collective_s']:.4f}s "
              f"useful={record['useful_flops_ratio']:.3f}")
    record["seconds"] = round(time.time() - t0, 2)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)
    print(f"(build {t_build:.1f}s, total {record['seconds']:.1f}s)")
    return record


def _job(arch, shape, mp, out_dir):
    tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
    out_path = os.path.join(out_dir, tag + ".json")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", out_path]
    if mp:
        cmd.append("--multi-pod")
    return tag, out_path, cmd


def run_all(out_dir: str, multi_pod_too: bool = True, timeout: int = 2400,
            jobs: int = 1) -> list:
    from repro_torch.launch.shapes import all_cells, applicable

    os.makedirs(out_dir, exist_ok=True)
    results, pending = [], []
    for arch, shape in all_cells():
        ok, reason = applicable(arch, shape)
        meshes = [False] + ([True] if multi_pod_too else [])
        for mp in meshes:
            if not ok:
                results.append({"arch": arch, "shape": shape,
                                "multi_pod": mp, "status": reason})
                continue
            tag, out_path, cmd = _job(arch, shape, mp, out_dir)
            if os.path.exists(out_path):
                with open(out_path) as f:
                    results.append(json.load(f))
                print(f"[cached] {tag}")
                continue
            pending.append((arch, shape, mp, tag, out_path, cmd))

    running: list = []

    def reap(block: bool):
        for item in list(running):
            (arch, shape, mp, tag, out_path, _), proc, t0, errf = item
            if proc.poll() is None:
                if time.time() - t0 > timeout:
                    proc.kill()
                    proc.wait()
                    errf.close()
                    results.append({"arch": arch, "shape": shape,
                                    "multi_pod": mp, "status": "TIMEOUT"})
                    print(f"[TIMEOUT] {tag}", flush=True)
                    running.remove(item)
                continue
            errf.close()
            with open(out_path + ".err") as f:
                err = f.read()
            os.remove(out_path + ".err")
            if proc.returncode == 0 and os.path.exists(out_path):
                with open(out_path) as f:
                    results.append(json.load(f))
                print(f"[ok] {tag} ({time.time() - t0:.1f}s)", flush=True)
            else:
                results.append({"arch": arch, "shape": shape,
                                "multi_pod": mp, "status": "FAIL",
                                "error": err[-2000:]})
                print(f"[FAIL] {tag}\n{err[-2000:]}", flush=True)
            running.remove(item)
        if block and running:
            time.sleep(0.2)

    try:
        for job in pending:
            while len(running) >= max(1, jobs):
                reap(block=True)
            print(f"[run] {job[3]}", flush=True)
            errf = open(job[4] + ".err", "w")
            proc = subprocess.Popen(job[5], stdout=subprocess.DEVNULL,
                                    stderr=errf)
            running.append((job, proc, time.time(), errf))
        while running:
            reap(block=True)
    finally:
        for _, proc, _, errf in running:
            proc.kill()
            proc.wait()
            errf.close()

    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    n_skip = sum(1 for r in results
                 if str(r.get("status", "")).startswith("SKIP"))
    n_bad = len(results) - n_ok - n_skip
    print(f"\n== dry-run sweep: {n_ok} ok, {n_skip} skipped, {n_bad} failed "
          f"of {len(results)} cell×mesh combos ==")
    if n_bad:
        sys.exit(1)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells run at once, one process each")
    ap.add_argument("--extra", default=None,
                    help="JSON dict of ModelConfig overrides")
    args = ap.parse_args()
    if args.all:
        run_all(args.out or "results/dryrun_torch",
                multi_pod_too=not args.single_pod_only, jobs=args.jobs)
    else:
        try:
            extra = json.loads(args.extra) if args.extra else None
            run_cell(args.arch, args.shape, args.multi_pod, args.out,
                     microbatches=args.microbatches, remat=args.remat,
                     extra_config=extra)
        except Exception:
            traceback.print_exc()
            sys.exit(1)


if __name__ == "__main__":
    main()
