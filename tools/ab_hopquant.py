#!/usr/bin/env python3
"""The int8_hopquant gradient sync of two checkouts, in turns, on one card.

    python3 tools/ab_hopquant.py ROOT_A ROOT_B [--out FILE.json]

Runs the ``acis_compressed`` sync with ``compressor="int8_hopquant"`` (kernels
on) at acis-100m's full width (12 leaves, 8 ranks on one ``LocalMesh``)
from each checkout's own ``src/repro_torch``, in the order A, B, B, A, each
in a process of its own (``--child ROOT``).  A child builds the seeded
gradients, ``init_state`` and ``init_arenas``, syncs once untimed, then
times 3 syncs (host clock between device syncs, the EF residual
threaded), and profiles one more under ``torch.profiler``: its device time
and, by kernel name, the launches and device ms of the rolls
(``roll_cuda_kernel``), the index kernels (``index_elementwise_kernel``:
per-rank takes and the all-gather's puts), the dtype copies
(``copy_kernel``) and the quant combines (``quant_``).  It prints one JSON
line with a digest of the first timed sync's outputs, so the two
checkouts can be seen to compute the same bits.  The parent prints the
four records and writes them to ``--out``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

COUNT = {"rolls": "roll_cuda_kernel", "index": "index_elementwise_kernel",
         "copies": "copy_kernel", "quant": "quant_"}


def child(root: Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import core as acis
    from repro_torch.configs.acis_100m import CONFIG, grad_leaf_specs
    from repro_torch.mesh import LocalMesh

    mesh = LocalMesh({"data": 8}, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    grads = {k: torch.randn((8,) + shape, device="cuda",
                            generator=gen).to(dt)
             for k, shape, dt in grad_leaf_specs(CONFIG)}
    eng = acis.make_engine("acis_compressed", compressor="int8_hopquant")
    state = eng.init_state(grads)
    arenas = eng.init_arenas(grads, mesh=mesh)

    def sync():
        nonlocal state
        out, state, _ = eng.gradient_sync(grads, state, arenas=arenas,
                                          mesh=mesh)
        return out

    sync()
    times, digest = [], None
    for step in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sync()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if step == 0:
            h = hashlib.sha256()
            for k in sorted(out):
                h.update(out[k].contiguous().view(torch.uint8).cpu().numpy())
            digest = h.hexdigest()[:16]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    counted = {label: {"launches": sum(c for k, (_, c) in by_name.items()
                                       if part in k),
                       "ms": sum(t for k, (t, _) in by_name.items()
                                 if part in k) / 1e3}
               for label, part in COUNT.items()}
    return {"root": str(root), "sync_ms": times,
            "median_sync_ms": statistics.median(times),
            "device_ms": sum(t for t, _ in by_name.values()) / 1e3,
            "launches": sum(c for _, c in by_name.values()),
            "counted": counted, "digest": digest,
            "device": torch.cuda.get_device_name(0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--child", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(Path(args.child).resolve())), flush=True)
        return 0
    if len(args.roots) != 2:
        ap.error("give two checkouts, A and B")
    a, b = (str(Path(r).resolve()) for r in args.roots)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    runs = []
    for root in (a, b, b, a):
        res = subprocess.run([sys.executable, __file__, "--child", root],
                             capture_output=True, text=True, check=True)
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    digests = {r["digest"] for r in runs}
    report = {"smi": smi, "runs": runs, "same_bits": len(digests) == 1}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({"smi": smi, "same_bits": report["same_bits"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
