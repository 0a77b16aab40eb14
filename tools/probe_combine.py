#!/usr/bin/env python3
"""Time launch-shape variants of ``csrc/fused_combine.cu`` on one card.

    python3 tools/probe_combine.py [--rounds 3] [--out FILE.json]

Builds the source once per variant of its build-time launch shape
(threads per block, loads in flight, resident grids per launch, cache
hints; see the macros at the top of the source), one shape for both
forms per variant besides the source's own defaults (``shipped``), all
``nvcc`` at once, into ``src/repro_torch/kernels/_build/probe/``.  Each
variant runs through the package's own wrappers at the acis-100m ring's
largest hop,
bf16 add, as ``chip_smoke.py`` times it: the elementwise form on two
``[8, 3,072,000]`` operands beside ``torch.add(out=)``, and the fused hop
from the ``[8, 8, 3,072,000]`` chunked input beside the shift + take +
add step it replaces.  Every variant is held bitwise against the plain
version first.  Each round times every entry once (``chip_smoke.
time_ms``: median of 25 CUDA-event windows of 10 calls), the order
rotated from round to round; the JSON lists each entry's readings and
its share of the bytes bound at the median.
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

# name: (threads, unroll, waves, stream) for both forms; waves 0 is one
# unrolled step per thread; "shipped" builds the source's defaults
VARIANTS = {
    "shipped": None,
    "t256_u4_w1": (256, 4, 1, 1),
    "t512_u4_w1": (512, 4, 1, 1),
    "t128_u4_w1": (128, 4, 1, 1),
    "t256_u2_w1": (256, 2, 1, 1),
    "t256_u8_w1": (256, 8, 1, 1),
    "t256_u4_w2": (256, 4, 2, 1),
    "t256_u4_w0": (256, 4, 0, 1),
    "t256_u2_w0": (256, 2, 0, 1),
    "t256_u1_w0": (256, 1, 0, 1),
    "t512_u2_w0": (512, 2, 0, 1),
    "t128_u2_w0": (128, 2, 0, 1),
    "t512_u4_w1_nohints": (512, 4, 1, 0),
    "t256_u2_w0_hophints": (256, 2, 0, 2),
}


def build_variants(names) -> dict:
    from repro_torch.kernels import build

    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        path = out_dir / f"fused_combine-{name}.so"
        defs = []
        if VARIANTS[name] is not None:
            threads, unroll, waves, stream = VARIANTS[name]
            for form in ("COMBINE", "HOP"):
                defs += [f"-DACIS_{form}_THREADS={threads}",
                         f"-DACIS_{form}_UNROLL={unroll}",
                         f"-DACIS_{form}_WAVES={waves}"]
            defs.append(f"-DACIS_COMBINE_STREAM={stream}")
        cmd = [build.nvcc(), *build.FLAGS, *defs, "-o", str(path),
               str(build.CSRC / "fused_combine.cu")]
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
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_combine: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import fused_combine as fc
    from repro_torch.kernels import ref
    from repro_torch.mesh import LocalMesh

    smi = cs.nvidia_smi()
    peak, *_ = cs.device_peaks(torch.cuda.get_device_name(0))
    libs = {k: fc.typed(v) for k, v in build_variants(VARIANTS).items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    x = torch.randn((8, 3_072_000), device=dev, generator=gen).bfloat16()
    y = torch.randn((8, 3_072_000), device=dev, generator=gen).bfloat16()
    out = torch.empty_like(x)
    xs = torch.randn((8, 8, 3_072_000), device=dev, generator=gen).bfloat16()
    buf = xs[:, 1].clone()
    mesh = LocalMesh({"data": 8}, device=dev)
    i = mesh.axis_index("data")
    bound_ms = 3 * x.numel() * x.element_size() / peak * 1e3

    def comb():
        return fc.fused_combine(x, y, op="add")

    def hop():
        return fc.fused_hop(buf, xs, 0, dim=0, rank_ndim=1)

    want_c = fc.plain(x, y, "add")
    want_h = ref.combine_add(mesh.shift(buf, "data", 1),
                             mesh.take(xs, (i - 2) % 8))
    for name, lib in libs.items():
        fc._LIB = lib
        if not (torch.equal(comb(), want_c) and torch.equal(hop(), want_h)):
            raise AssertionError(f"{name} differs from the plain version")

    entries = {"torch.add": (None, lambda: torch.add(x, y, out=out)),
               "unfused_step": (None, lambda: ref.combine_add(
                   mesh.shift(buf, "data", 1), mesh.take(xs, (i - 2) % 8)))}
    for name, lib in libs.items():
        entries[f"{name}/combine"] = (lib, comb)
        entries[f"{name}/hop"] = (lib, hop)
    readings = {k: [] for k in entries}
    order = list(entries)
    for r in range(args.rounds):
        k = r * len(order) // args.rounds
        for name in order[k:] + order[:k]:
            lib, fn = entries[name]
            if lib is not None:
                fc._LIB = lib
            readings[name].append(cs.time_ms(fn))
    fc._LIB = None
    res = {k: {"ms": v, "median_ms": statistics.median(v),
               "share_of_bound": bound_ms / statistics.median(v)}
           for k, v in readings.items()}
    report = {"smi": smi, "shape": [8, 3_072_000], "dtype": "bfloat16",
              "op": "add", "bound_ms": bound_ms,
              "variants": {k: v and dict(zip(("threads", "unroll", "waves",
                                              "stream"), v))
                           for k, v in VARIANTS.items()},
              "res": res}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
