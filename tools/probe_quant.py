#!/usr/bin/env python3
"""Time launch-shape variants of ``csrc/quant_combine.cu`` on one card.

    python3 tools/probe_quant.py [--rounds 3] [--baseline OLD.cu] [--out FILE.json]

Builds the source once per variant of its build-time launch shape
(threads per block, loads in flight per operand, resident grids per
launch, cache hints; see the macros at the top of the source), besides
the source's own defaults (``shipped``), all ``nvcc`` at once, into
``src/repro_torch/kernels/_build/probe/``.  Every variant runs through the
package's own wrappers and is first held bit for bit against the plain
versions by ``chip_smoke.quant_checks`` and ``chip_smoke.quant_hop_checks``
(exact rows, the NaN row, ragged rows, every hop of a ring of 8 on one
axis and the second of two, and the largest hop).  Then, at the largest
int8_hopquant hop of acis-100m (the embed leaf: [8, 12,000, 256] int8 and
[8, 12,000] f32 a chunk), each round times every entry once
(``chip_smoke.time_ms``: median of 25 CUDA-event windows of 10 calls),
the order rotated from round to round: each variant's ring-hop form from
the [8, 8, 12,000, 256] chunked input and its elementwise form on two
[8, 12,000, 256] operands, the unfused ring step (shift + take +
the shipped elementwise kernel), and, with ``--baseline``, an earlier
source's elementwise kernel (its C entry ``acis_quant_combine(qa, sa, qb,
sb, qo, so, rows, stream)``, e.g. ``git show <rev>:src/repro_torch/
kernels/csrc/quant_combine.cu``).  The JSON lists each entry's readings
and its share of the bytes bound at the median, and each variant's device
time a launch of the hop kernel from the profiler (``chip_smoke.
per_launch``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent

# name: (threads, unroll, waves, stream); waves 0 is one step per warp;
# "shipped" builds the source's defaults
VARIANTS = {
    "shipped": None,
    "t256_u2_w1": (256, 2, 1, 0),
    "t64_u2_w1": (64, 2, 1, 0),
    "t128_u1_w1": (128, 1, 1, 0),
    "t128_u4_w1": (128, 4, 1, 0),
    "t256_u4_w1": (256, 4, 1, 0),
    "t128_u2_w2": (128, 2, 2, 0),
    "t128_u2_w0": (128, 2, 0, 0),
    "t128_u2_w1_hints": (128, 2, 1, 1),
    "t128_u2_w1_allhints": (128, 2, 1, 2),
}


def compile_all(jobs: dict) -> dict:
    """``{name: (source, defines)}`` -> ``{name: CDLL}``, one ``nvcc``
    each, all at once."""
    from repro_torch.kernels import build

    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, defs) in jobs.items():
        path = out_dir / f"quant_combine-{name}.so"
        cmd = [build.nvcc(), *build.FLAGS, *defs, "-o", str(path), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       path)
    libs = {}
    for name, (proc, path) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{text}")
        libs[name] = ctypes.CDLL(str(path))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--baseline", default=None,
                    help="an earlier quant_combine.cu to time beside")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_quant: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs.acis_100m import CONFIG
    from repro_torch.kernels import build
    from repro_torch.kernels import quant_combine as qc
    from repro_torch.mesh import LocalMesh

    smi = cs.nvidia_smi()
    peak, _, _ = cs.device_peaks(torch.cuda.get_device_name(0))
    src = build.CSRC / "quant_combine.cu"
    jobs = {}
    for name, v in VARIANTS.items():
        defs = []
        if v is not None:
            defs = [f"-DACIS_QUANT_{k}={x}" for k, x in
                    zip(("THREADS", "UNROLL", "WAVES", "STREAM"), v)]
        jobs[name] = (src, defs)
    if args.baseline:
        jobs["baseline"] = (Path(args.baseline).resolve(), [])
    libs = compile_all(jobs)
    base = libs.pop("baseline", None)
    libs = {k: qc.typed(v) for k, v in libs.items()}

    dev = torch.device("cuda")
    checks = {}
    for name, lib in libs.items():
        qc._LIB = lib
        gen = torch.Generator(device=dev).manual_seed(7)
        checks[name] = {"quant_combine": cs.quant_checks(dev, gen)["cases"],
                        "quant_hop": cs.quant_hop_checks(dev, gen)["cases"]}

    gen = torch.Generator(device=dev).manual_seed(99)
    ranks, blocks = cs.biggest_hop_rows(CONFIG, 8)
    qx = torch.randint(-127, 128, (ranks, 8, blocks, 256), device=dev,
                       generator=gen, dtype=torch.int8)
    sx = torch.rand((ranks, 8, blocks), device=dev, generator=gen)
    qbuf, sbuf = qx[:, 1].clone(), sx[:, 1].clone()
    qa, sa = qx[:, 2].clone(), sx[:, 2].clone()
    mesh = LocalMesh({"data": 8}, device=dev)
    i = mesh.axis_index("data")
    bound_ms = ranks * blocks * 3 * (256 + 4) / peak * 1e3

    def hop():
        return qc.quant_hop(qbuf, sbuf, qx, sx, 0, dim=0, rank_ndim=1)

    def comb():
        return qc.quant_combine(qbuf, sbuf, qa, sa)

    def unfused():
        c = (i - 2) % 8
        return qc.quant_combine(mesh.shift(qbuf, "data", 1),
                                mesh.shift(sbuf, "data", 1),
                                mesh.take(qx, c), mesh.take(sx, c))

    entries = {"unfused_step": (libs["shipped"], unfused)}
    if base is not None:
        fn = base.acis_quant_combine
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        qo, so = torch.empty_like(qbuf), torch.empty_like(sbuf)

        def baseline():
            rc = fn(qbuf.data_ptr(), sbuf.data_ptr(), qa.data_ptr(),
                    sa.data_ptr(), qo.data_ptr(), so.data_ptr(), sbuf.numel(),
                    build.stream_of(0))
            if rc != 0:
                raise RuntimeError(f"baseline launch failed ({rc})")
        baseline()
        wq, ws = qc.plain(qbuf, sbuf, qa, sa)
        if not (torch.equal(qo, wq) and torch.equal(so, ws)):
            raise AssertionError("baseline differs from the plain version")
        entries["baseline/combine"] = (None, baseline)
    for name, lib in libs.items():
        entries[f"{name}/hop"] = (lib, hop)
        entries[f"{name}/combine"] = (lib, comb)
    readings = {k: [] for k in entries}
    order = list(entries)
    for r in range(args.rounds):
        k = r * len(order) // args.rounds
        for name in order[k:] + order[:k]:
            lib, fn_ = entries[name]
            if lib is not None:
                qc._LIB = lib
            readings[name].append(cs.time_ms(fn_))
    device = {}
    for name, lib in libs.items():
        qc._LIB = lib
        device[name] = cs.per_launch(hop, "quant_hop_kernel")
    qc._LIB = None
    res = {k: {"ms": v, "median_ms": statistics.median(v),
               "share_of_bound": bound_ms / statistics.median(v)}
           for k, v in readings.items()}
    report = {"smi": smi, "shape": [ranks, 8, blocks, 256],
              "bytes": ranks * blocks * 3 * (256 + 4), "bound_ms": bound_ms,
              "variants": {k: v and dict(zip(("threads", "unroll", "waves",
                                              "stream"), v))
                           for k, v in VARIANTS.items()},
              "checks": checks, "res": res,
              "hop_device_ms_per_launch": device}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
