#!/usr/bin/env python3
"""Time ``csrc/prefix_sum.cu`` on one card, beside an earlier design.

    python3 tools/probe_scan.py [--rounds 3] [--baseline OLD.cu] [--out FILE.json]

Builds the source at each tile height in ``ROWS`` (``ACIS_SCAN_ROWS`` rows
a thread: 32 rows are 8,192 elements a tile at one lane), all ``nvcc`` at
once, into
``src/repro_torch/kernels/_build/probe/``, and runs each through the
package's wrapper with ``chunk_scan.ROWS`` set to match.  Every build is
first held to ``chip_smoke.prefix_checks`` (integer-valued data bitwise,
random data within ``scan_tolerance``), and the elements that differ
between two runs on one random input are counted.  Then each round times
every entry once (``chip_smoke.time_ms``: median of 25 CUDA-event windows
of 10 calls), the order rotated from round to round, at fig5_scan's
[8, 2^20] and fig5_scan_2d's [8, 16384, 64] f32 along dim 1, beside
``torch.cumsum`` and, with ``--baseline``, an earlier source (its C entry
``acis_prefix_sum(x, out, carry, B, T, D, lb, tiles, dtype, stream)``,
the reduce-then-scan of ``git show <rev>:src/repro_torch/kernels/csrc/
prefix_sum.cu``, with B * D * tiles floats of carries).  The JSON lists
each entry's readings and its share of the bytes bound at the median,
and each build's device time a launch of its scan kernel from the
profiler (``chip_smoke.per_launch``: without the scratch's memset).
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

ROWS = (16, 32, 48, 64)


def compile_all(jobs: dict) -> dict:
    """``{name: (source, defines)}`` -> ``{name: CDLL}``, one ``nvcc``
    each, all at once."""
    from repro_torch.kernels import build

    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, defs) in jobs.items():
        path = out_dir / f"prefix_sum-{name}.so"
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
                    help="an earlier prefix_sum.cu to time beside")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_scan: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import chunk_scan as sc

    smi = cs.nvidia_smi()
    peak, *_ = cs.device_peaks(torch.cuda.get_device_name(0))
    src = build.CSRC / "prefix_sum.cu"
    jobs = {f"rows{r}": (src, [f"-DACIS_SCAN_ROWS={r}"]) for r in ROWS}
    if args.baseline:
        jobs["baseline"] = (Path(args.baseline).resolve(), [])
    libs = compile_all(jobs)
    base = libs.pop("baseline", None)
    libs = {k: sc.typed(v) for k, v in libs.items()}

    def use(name):
        sc._LIB, sc.ROWS = libs[name], int(name[4:])

    dev = torch.device("cuda")
    checks = {}
    for name in libs:
        use(name)
        gen = torch.Generator(device=dev).manual_seed(7)
        r = cs.prefix_checks(dev, gen)
        checks[name] = {k: r[k] for k in ("cases", "max_err_over_bound",
                                          "run_to_run_differing_elements")}

    gen = torch.Generator(device=dev).manual_seed(99)
    shapes = {"1d": (8, 1 << 20), "2d": (8, 16384, 64)}
    xs = {k: torch.randn(v, device=dev, generator=gen)
          for k, v in shapes.items()}
    entries = {}
    for k, x in xs.items():
        entries[f"torch.cumsum/{k}"] = (None, lambda x=x: torch.cumsum(x, 1))
        for name in libs:
            entries[f"{name}/{k}"] = (
                name, lambda x=x: sc.prefix_sum(x, 1))
    if base is not None:
        fn = base.acis_prefix_sum
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
            ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sc.ROWS = 16                 # the earlier design's tile height
        for k, x in xs.items():
            b, t, d, lb, tiles = sc.layout(tuple(x.shape), 1)
            out = torch.empty_like(x)

            def baseline(x=x, out=out, b=b, t=t, d=d, lb=lb, tiles=tiles):
                carry = torch.empty((b * d * tiles,), device=dev)
                rc = fn(x.data_ptr(), out.data_ptr(), carry.data_ptr(), b, t,
                        d, lb, tiles, 0, build.stream_of(0))
                if rc != 0:
                    raise RuntimeError(f"baseline launch failed ({rc})")
                return out
            exact, tol = cs.scan_tolerance(x, 1)
            cs.scan_err(baseline(), exact, tol, "baseline")
            entries[f"baseline/{k}"] = (None, baseline)
    readings = {k: [] for k in entries}
    order = list(entries)
    for r in range(args.rounds):
        k = r * len(order) // args.rounds
        for name in order[k:] + order[:k]:
            lib, fn_ = entries[name]
            if lib is not None:
                use(lib)
            readings[name].append(cs.time_ms(fn_))
    device = {}
    for name in libs:
        use(name)
        for k, x in xs.items():
            device[f"{name}/{k}"] = cs.per_launch(
                lambda x=x: sc.prefix_sum(x, 1), "scan_kernel")
    sc._LIB, sc.ROWS = None, 16
    bound = {k: 2 * x.numel() * 4 / peak * 1e3 for k, x in xs.items()}
    res = {k: {"ms": v, "median_ms": statistics.median(v),
               "share_of_bound": bound[k.split("/")[1]]
               / statistics.median(v)}
           for k, v in readings.items()}
    report = {"smi": smi, "shapes": shapes, "bound_ms": bound,
              "checks": checks, "res": res,
              "device_ms_per_launch": device}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
