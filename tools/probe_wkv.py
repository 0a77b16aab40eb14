#!/usr/bin/env python3
"""Time launch-shape variants of ``csrc/rwkv6_recurrence.cu`` on one card.

    python3 tools/probe_wkv.py [--rounds 3] [--baseline FILE.cu] [--out FILE.json]

Builds the source once per variant of its build-time launch shape (lanes
sharing a value column, value columns a block, columns a thread, tokens a
stage, stages, tokens a loop step interleaves; the
``ACIS_WKV_*`` macros at the top of the source), the
source's own defaults as ``shipped``, all ``nvcc`` at once, into
``src/repro_torch/kernels/_build/probe/``.  ``--baseline`` adds an
earlier design's source as ``baseline``: one whose entry point takes no
device argument, as the first design's did (``git show <rev>:src/
repro_torch/kernels/csrc/rwkv6_recurrence.cu``).
Each variant runs through the package's wrapper at the rwkv6-1.6b serve
phase's two WKV calls, as ``chip_smoke.py`` times them: prefill ([8, 512,
32, 64] bf16 in the model's layout, ``kv_bf16``, from a zero state) and
decode ([8, 1, 32, 64] from a state, in place).  Every variant is first
held within ``wkv_tolerance`` of the float64 recurrence at both shapes and
at ragged ones (K and V off the lane split, V past one block).  Each
round times every variant's prefill once (``chip_smoke.time_ms``: median
of 25 CUDA-event windows of 10 calls), the order rotated from round to
round, with and without ``kv_bf16`` (the rounding's share); decode's
device time per launch comes from one profile of 50
calls per variant.  The JSON lists each variant's readings and its share
of the operations bound at the median, and the shipped shape's prefill
time at batch 1, 2, 4 and 8 (32 to 256 blocks on 132 SMs).
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

# name: (groups, value columns a block, columns a thread, chunk, stages,
# tokens unrolled, registers a thread or 0); "shipped" builds the
# source's defaults
VARIANTS = {
    "shipped": None,
    "g8_c2_u1": (8, 64, 2, 16, 3, 1, 0),
    "g8_c2_u4": (8, 64, 2, 16, 3, 4, 0),
    "g8_c2_chunk32": (8, 64, 2, 32, 2, 2, 0),
    "g8_c4_u2": (8, 64, 4, 16, 3, 2, 0),
    "g4_c2_u2": (4, 64, 2, 16, 3, 2, 0),
    "g4_c4_u2": (4, 64, 4, 16, 3, 2, 0),
    "g16_c4_u2": (16, 64, 4, 16, 3, 2, 0),
    "g8_c1_u2": (8, 64, 1, 16, 3, 2, 0),
    "g4_c1_u2": (4, 64, 1, 16, 3, 2, 0),
    "g8_c2_v32": (8, 32, 2, 16, 3, 2, 0),
    # the same layouts with the registers the compiler would not give
    "g8_c2_u4_r128": (8, 64, 2, 16, 3, 4, 128),
    "g8_c4_u2_r168": (8, 64, 4, 16, 3, 2, 168),
    "g8_c4_u2_r224": (8, 64, 4, 16, 3, 2, 224),
    "g8_c4_u4_r224": (8, 64, 4, 16, 3, 4, 224),
    "g16_c8_u2_r224": (16, 64, 8, 16, 3, 2, 224),
    "g8_c8_u2_r255": (8, 64, 8, 16, 3, 2, 255),
    "g4_c4_u2_r255": (4, 64, 4, 16, 3, 2, 255),
}
MACROS = ("GROUPS", "VCOLS", "CPT", "CHUNK", "STAGES", "UNROLL", "MAXNREG")
# (batch, T, heads, K, V) held against the float64 recurrence per variant
CHECKS = ((8, 512, 32, 64, 64), (8, 1, 32, 64, 64), (1, 77, 3, 40, 24),
          (2, 9, 2, 64, 56), (1, 20, 2, 8, 8))


def build_variants(names, baseline=None) -> dict:
    from repro_torch.kernels import build

    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {n: (build.CSRC / "rwkv6_recurrence.cu",
                [] if VARIANTS[n] is None else
                [f"-DACIS_WKV_{m}={x}" for m, x in zip(MACROS, VARIANTS[n])])
            for n in names}
    if baseline:
        jobs["baseline"] = (Path(baseline), [])
    procs = {}
    for name, (src, defs) in jobs.items():
        path = out_dir / f"rwkv6_recurrence-{name}.so"
        cmd = [build.nvcc(), *build.FLAGS, *defs, "-o", str(path), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       path)
    libs, ptxas = {}, {}
    for name, (proc, path) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{text}")
        libs[name] = ctypes.CDLL(str(path))
        ptxas[name] = [ln for ln in text.splitlines()
                       if "registers" in ln or "spill" in ln]
    return libs, ptxas


class Baseline:
    """An earlier source's entry point, which takes no device argument,
    behind the wrapper's call."""

    def __init__(self, lib):
        self.fn = lib.acis_rwkv6_recurrence
        self.fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 3 \
            + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        self.fn.restype = ctypes.c_int

    def acis_rwkv6_recurrence(self, *args):
        return self.fn(*args[:-2], args[-1])        # drops the device


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_wkv: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import rwkv6_recurrence as rk

    smi = cs.nvidia_smi()
    _, f32_peak, *_ = cs.device_peaks(torch.cuda.get_device_name(0))
    libs, ptxas = build_variants(VARIANTS, args.baseline)

    typed = {n: (Baseline(lib) if n == "baseline" else rk.typed(lib))
             for n, lib in libs.items()}

    def use(name):
        rk._LIB = typed[name]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    worst = {}
    for b, t, h, k, v in CHECKS:
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and t == 512:
                continue
            xs = cs.wkv_inputs(dev, gen, b, t, h, k, v, dtype,
                               model_w=h == 32)
            s0 = torch.randn((b, h, k, v), device=dev, generator=gen)
            eo, es, otol, stol = rk.wkv_tolerance(*xs, s0, kv_bf16=True)
            for name in libs:
                use(name)
                st = s0.clone()
                o, s = rk.rwkv6_recurrence(*xs, st, kv_bf16=True, s_out=st)
                torch.cuda.synchronize()
                ratio = max(((o.double() - eo).abs()
                             / otol.clamp_min(1e-300)).max().item(),
                            ((s.double() - es).abs()
                             / stol.clamp_min(1e-300)).max().item())
                if not ratio <= 1.0:
                    raise AssertionError(f"{name} {(b, t, h, k, v)} {dtype}:"
                                         f" {ratio} x wkv_tolerance")
                worst[name] = max(worst.get(name, 0.0), ratio)

    b, t, h, hd = 8, 512, 32, 64
    pre = cs.wkv_inputs(dev, gen, b, t, h, hd, hd)
    z = torch.zeros((b, h, hd, hd), device=dev)
    dec = cs.wkv_inputs(dev, gen, b, 1, h, hd, hd)
    sd = torch.randn((b, h, hd, hd), device=dev, generator=gen)
    _, flops = cs.wkv_work(b, t, h, hd, hd, 2)
    bound_ms = flops / f32_peak * 1e3
    dbytes, _ = cs.wkv_work(b, 1, h, hd, hd, 2)

    def prefill():
        rk.rwkv6_recurrence(*pre, z, kv_bf16=True)

    def prefill_exact():          # kv kept in f32: the rounding's share
        rk.rwkv6_recurrence(*pre, z)

    def decode():
        rk.rwkv6_recurrence(*dec, sd, kv_bf16=True, s_out=sd)

    readings = {k: [] for k in libs}
    exact = {k: [] for k in libs}
    order = list(libs)
    for r in range(args.rounds):
        k0 = r * len(order) // args.rounds
        for name in order[k0:] + order[:k0]:
            use(name)
            readings[name].append(cs.time_ms(prefill))
            exact[name].append(cs.time_ms(prefill_exact))
    res = {}
    for name in libs:
        use(name)
        prof = cs.device_profile(lambda: [decode() for _ in range(50)])
        per = [x for x in prof.get("top", []) if "wkv_kernel" in x["name"]]
        med = statistics.median(readings[name])
        res[name] = {"prefill_ms": readings[name], "median_ms": med,
                     "share_of_bound": bound_ms / med,
                     "prefill_exact_kv_ms": exact[name],
                     "decode_device_ms_per_launch":
                         per[0]["ms"] / per[0]["count"] if per else None,
                     "max_err_over_tolerance": worst[name],
                     "ptxas": ptxas[name]}
    # the shipped shape at fewer (batch, head) blocks than SMs and more:
    # per-token time flat in the batch means each block's chain bounds it
    use("shipped")
    by_batch = {}
    for bb in (1, 2, 4, 8):
        xs = [x[:bb] for x in pre[:4]] + [pre[4]]
        by_batch[bb] = cs.time_ms(
            lambda: rk.rwkv6_recurrence(*xs, z[:bb], kv_bf16=True))
    rk._LIB = None
    report = {"shipped_ms_by_batch": by_batch,"smi": smi, "prefill_shape": [b, t, h, hd],
              "dtype": "bfloat16, kv_bf16", "bound_ms": bound_ms,
              "bound_by": "operations", "decode_bytes": dbytes,
              "variants": {k: v and dict(zip(MACROS, v))
                           for k, v in VARIANTS.items()},
              "shipped_shape": rk.built_launch_shape(64, 64, typed["shipped"]),
              "res": res}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({k: (v["median_ms"],
                          statistics.median(v["prefill_exact_kv_ms"]),
                          v["decode_device_ms_per_launch"])
                      for k, v in res.items()}))
    print(json.dumps({"shipped_ms_by_batch": by_batch}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
