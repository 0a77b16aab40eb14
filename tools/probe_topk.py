#!/usr/bin/env python3
"""Measure what bounds ``topk_accumulate`` on one card, and time its forms.

    python3 tools/probe_topk.py [--rounds 3] [--out FILE.json]

At the acis-100m ``topk`` sync's leaf shapes (1% of each leaf's lanes, k
distinct random int32 indices a row, into an f32 ``[8, size]``
accumulator: the embed leaf, an FFN leaf, an attention leaf) it times,
each entry first held bit for bit against the plain version:

  (a) ``first``: the port's first design (one thread an entry, a
      grid-stride loop of 132 x 32 blocks, an int64 division per entry),
      from ``tools/topk_candidates.cu``;
  (b) ``first_sorted``: the same kernel on the same payload sorted by index
      within each row, the best any address ordering can give it;
  (c) ``index_add``: ``Tensor.index_add_`` on the flattened accumulator;
  (d) the shipped source (``csrc/topk_accum.cu``) through the package's
      wrapper in a few launch shapes (``direct_<variant>``, the
      ``ACIS_TOPK_*`` macros), ``direct_sorted`` on the sorted payload, and
      the binned form of ``tools/topk_candidates.cu`` (``binned_s<shift>``:
      a counting sort by windows of 2^shift lanes first, raised where a row
      would pass 8,192 windows).

Each round times every entry once (``chip_smoke.time_ms``: median of 25
CUDA-event windows of 10 calls, each call adding into the same
accumulator), the order rotated from round to round.  The JSON gives
each entry's readings, the bytes bound by the measurement rule (4 bytes a
lane) and the sector bound: the payload's bytes plus 64 bytes (a 32-byte
sector read and written back) for each distinct sector of the accumulator
that the payload touches.
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

CANDIDATES = ROOT / "tools" / "topk_candidates.cu"
# name: {macro: value} of csrc/topk_accum.cu; "shipped" its defaults
VARIANTS = {"shipped": {}, "u2": {"UNROLL": 2}, "u4": {"UNROLL": 4},
            "vec4": {"VEC": 4}, "vec4_u2": {"VEC": 4, "UNROLL": 2},
            "t128": {"THREADS": 128}, "t512": {"THREADS": 512}}
SHIFTS = (10, 12, 13, 14, 16, 18)
MAX_BINS = 8192                  # tools/topk_candidates.cu: kMaxBins
# (name, lanes a row): the topk sync's leaves, 8 rows, k = 1% of the lanes
LEAVES = (("embed", 24_576_000), ("ffn", 18_874_368), ("attn_kv", 2_359_296))


def build_all() -> dict:
    from repro_torch.kernels import build

    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {"candidates": (CANDIDATES, [])}
    for name, defs in VARIANTS.items():
        jobs[name] = (build.CSRC / "topk_accum.cu",
                      [f"-DACIS_TOPK_{m}={x}" for m, x in defs.items()])
    procs = {}
    for name, (src, defs) in jobs.items():
        path = out_dir / f"topk-{name}.so"
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
    cand = libs["candidates"]
    cand.first_topk_accumulate.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    cand.binned_topk_accumulate.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p]
    cand.binned_scratch_elems.argtypes = [ctypes.c_int64] * 3 + [ctypes.c_int]
    cand.binned_scratch_elems.restype = ctypes.c_int64
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_topk: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import topk_accum as ta

    smi = cs.nvidia_smi()
    peak, *_ = cs.device_peaks(torch.cuda.get_device_name(0))
    libs = build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    cand = libs["candidates"]

    def first(dense, idx, vals):
        rc = cand.first_topk_accumulate(
            dense.data_ptr(), idx.data_ptr(), vals.data_ptr(),
            dense.shape[0], dense.shape[1], idx.shape[1],
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"first design: launch failed ({rc})")

    def binned(shift):
        def call(dense, idx, vals):
            rows, size, k = dense.shape[0], dense.shape[1], idx.shape[1]
            scratch = torch.empty(cand.binned_scratch_elems(rows, size, k,
                                                            shift),
                                  dtype=torch.int32, device=dense.device)
            rc = cand.binned_topk_accumulate(
                dense.data_ptr(), idx.data_ptr(), vals.data_ptr(), rows, size,
                k, shift, scratch.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"binned form: launch failed ({rc})")
        return call

    typed = {name: ta.typed(libs[name]) for name in VARIANTS}

    def shipped(lib):
        def call(dense, idx, vals):
            ta._LIB = typed[lib]
            ta.topk_accumulate_(dense, idx, vals)
        return call

    report = {"smi": smi, "variants": VARIANTS, "leaves": {}}
    for leaf, size in LEAVES:
        rows, k = 8, int(size * 0.01)
        idx = torch.stack([torch.randperm(size, device=dev, generator=gen)[:k]
                           for _ in range(rows)]).to(torch.int32)
        vals = torch.randn((rows, k), device=dev, generator=gen)
        sidx, order = idx.sort(dim=1)
        svals = vals.gather(1, order)
        flat_idx = (idx.long() + torch.arange(rows, device=dev)[:, None]
                    * size).view(-1)
        flat_vals = vals.reshape(-1)
        sectors = sum(torch.unique(idx[r].long() // 8).numel()
                      for r in range(rows))
        payload = rows * k * 8
        entries = {
            "first": lambda d: first(d, idx, vals),
            "first_sorted": lambda d: first(d, sidx, svals),
            "index_add": lambda d: d.view(-1).index_add_(0, flat_idx,
                                                         flat_vals),
        }
        for lib in VARIANTS:
            entries[f"direct_{lib}"] = (lambda fn: lambda d: fn(d, idx, vals))(
                shipped(lib))
        entries["direct_sorted"] = (lambda fn: lambda d: fn(d, sidx, svals))(
            shipped("shipped"))
        least = max(0, (-(-size // MAX_BINS) - 1).bit_length())
        for shift in sorted({max(s_, least) for s_ in SHIFTS}):
            entries[f"binned_s{shift}"] = (lambda fn: lambda d: fn(
                d, idx, vals))(binned(shift))

        want = torch.zeros((rows, size), device=dev)
        ta.plain(want, idx, vals)
        dense = torch.zeros((rows, size), device=dev)
        for name, fn in entries.items():
            dense.zero_()
            fn(dense)
            torch.cuda.synchronize()
            if not torch.equal(dense, want):
                raise AssertionError(f"{leaf} {name}: differs from the plain "
                                     "version")
        del want
        readings = {n: [] for n in entries}
        order_ = list(entries)
        for r in range(args.rounds):
            k0 = r * len(order_) // args.rounds
            for name in order_[k0:] + order_[:k0]:
                readings[name].append(cs.time_ms(
                    (lambda fn: lambda: fn(dense))(entries[name])))
        ta._LIB = None
        rule_bytes = rows * k * (4 + 4 + 4 + 4)
        report["leaves"][leaf] = {
            "shape": [rows, size], "k": k,
            "bound_ms": rule_bytes / peak * 1e3,
            "sectors": sectors,
            "sector_bound_ms": (payload + 64 * sectors) / peak * 1e3,
            "res": {n: {"ms": v, "median_ms": statistics.median(v)}
                    for n, v in readings.items()}}
        del dense, idx, vals, sidx, svals, flat_idx, flat_vals, order
        torch.cuda.empty_cache()
        print(json.dumps({leaf: {n: round(v["median_ms"], 5) for n, v in
                                 report["leaves"][leaf]["res"].items()}}),
              flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
