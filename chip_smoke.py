#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out chiprun_out/chip_smoke.json]

Phases, one JSON line each:

  1. env      — torch / CUDA versions, the card's name and power limit,
                nvcc, ninja
  2. build    — builds every CUDA kernel from ``src/repro_torch/kernels/
                csrc`` (one nvcc per source, all at once)
  3. kernels  — each kernel against its plain PyTorch version on the card
                (bitwise; bf16 ``mac`` within one bf16 ulp), then timed at
                the main path's shapes with CUDA events beside its plain
                version, one PyTorch library call computing the same
                function, and its device-memory bound
  4. main     — the acis-100m gradient sync at full width (12 leaves,
                124,668,672 parameters per rank, 8 ranks on one
                ``LocalMesh``): ``make_engine("acis")`` with kernels on,
                ``init_arenas`` and 3 ``gradient_sync`` steps; bitwise equal
                to the same sync with ``use_kernels=False``, within bf16
                rounding of the ``xla`` backend and of the exact f32 mean;
                arenas written in place; every hop and every bucket pack
                launched its kernel

Then the ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and, last, ``{"ok": true, "device": ...}``.
Any failed check raises: the exit code is non-zero and no ``ok`` line is
printed.  Without a CUDA device, or without the repository around it, the
script stops before any phase.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# device-memory peak by card name (NVIDIA data sheets): the bound_ms
# denominator.
HBM_PEAK = (
    ("H100 PCIe", 2.0e12, "H100 PCIe: 2.0 TB/s HBM2e"),
    ("H100", 3.35e12, "H100 SXM: 3.35 TB/s HBM3"),
    ("H200", 4.8e12, "H200: 4.8 TB/s HBM3e"),
)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def hbm_peak(name: str) -> tuple[float, str]:
    for key, peak, note in HBM_PEAK:
        if key in name:
            return peak, note
    raise RuntimeError(f"no device-memory peak known for {name!r}")


def time_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` calls each,
    per call, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions, then timed
# ---------------------------------------------------------------------------

def _bitwise_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """0.0 when equal bit for bit (NaN lanes must be NaN in both);
    raises otherwise."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"shape/dtype {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    if got.dtype.is_floating_point:
        gn, wn = torch.isnan(got), torch.isnan(want)
        check(torch.equal(gn, wn), "NaN lanes differ")
        got, want = got[~gn], want[~wn]
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.int8: torch.int8}[got.dtype]
    diff = (got.view(bits) != want.view(bits)).sum().item()
    if diff:
        err = (got.float() - want.float()).abs().max().item()
        raise AssertionError(f"{diff} lanes differ, max |err| {err}")
    return 0.0


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    ulp = torch.where(w == 0, torch.full_like(w, 2.0 ** -133),
                      2.0 ** (torch.floor(torch.log2(w.abs())) - 7))
    return ((g - w).abs() / ulp).max().item()


def kernel_checks(dev) -> dict:
    from repro_torch.kernels import fused_combine as fc
    from repro_torch.kernels import pack_combine as pc

    gen = torch.Generator(device=dev).manual_seed(1234)

    def data(shape, dtype):
        if dtype == torch.int8:
            return torch.randint(-128, 128, shape, device=dev,
                                 generator=gen, dtype=torch.int8)
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    report = {"fused_combine": {"cases": 0, "max_abs_err": 0.0,
                                "mac_bf16_max_ulp": 0.0},
              "fused_pack": {"cases": 0, "max_abs_err": 0.0}}
    sizes = [(1,), (127,), (65539,), (8, 3_072_000)]
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        ops = ["add", "max", "min"] + (["mac"] if dtype != torch.int8 else [])
        for op in ops:
            for shape in sizes:
                if shape == (8, 3_072_000) and dtype != torch.bfloat16:
                    continue                  # the path's hop is bf16
                x, y = data(shape, dtype), data(shape, dtype)
                if op in ("max", "min") and dtype != torch.int8 \
                        and x.numel() > 4:
                    x.view(-1)[1] = float("nan")
                    y.view(-1)[2] = float("nan")
                    x.view(-1)[3] = float("nan")
                    y.view(-1)[3] = float("nan")
                got = fc.fused_combine(x, y, op=op, alpha=0.3)
                want = fc.plain(x, y, op, 0.3)
                torch.cuda.synchronize()
                r = report["fused_combine"]
                r["cases"] += 1
                if op == "mac" and dtype == torch.bfloat16:
                    ulps = _bf16_ulps(got, want)
                    check(ulps <= 1.0, f"bf16 mac {ulps} ulp off")
                    r["mac_bf16_max_ulp"] = max(r["mac_bf16_max_ulp"], ulps)
                    err = (got.float() - want.float()).abs().max().item()
                else:
                    err = _bitwise_err(got, want)
                r["max_abs_err"] = max(r["max_abs_err"], err)

    # pack: ragged parts, a tail past the parts that must survive, in place
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for op in (None, "add", "max", "min"):
            for rows, sizes_, tail in (((8,), (768, 9216, 9216), 0),
                                       ((8,), (1, 100, 0, 3333), 7),
                                       ((), (5,), 3)):
                arena = data(rows + (sum(sizes_) + tail,), dtype)
                if op and dtype != torch.int8 and arena.numel() > 8:
                    arena.view(-1)[2] = float("nan")
                parts = [data(rows + (s,), dtype) for s in sizes_]
                want = pc.plain(arena.clone(), *parts, op=op)
                ptr = arena.data_ptr()
                before = arena[..., sum(sizes_):].clone()
                got = pc.fused_pack(arena, *parts, op=op)
                torch.cuda.synchronize()
                check(got is arena and arena.data_ptr() == ptr,
                      "pack did not write the arena in place")
                check(torch.equal(arena[..., sum(sizes_):], before),
                      "tail lanes changed")
                r = report["fused_pack"]
                r["cases"] += 1
                r["max_abs_err"] = max(r["max_abs_err"],
                                       _bitwise_err(got, want))
    try:
        pc.fused_pack(data((8, 10), torch.float32),
                      data((8, 6), torch.float32), data((8, 5), torch.float32))
    except ValueError:
        report["fused_pack"]["overflow_raises"] = True
    check(report["fused_pack"].get("overflow_raises", False),
          "an overflowing pack did not raise")
    return report


def kernel_timings(dev, peak: float) -> dict:
    """Each kernel at the main path's shapes: the largest hop (bf16
    [8, 3,072,000] add) and the Coalesce bucket pack (f32 parts of 768,
    9216 and 9216 per rank into the [8, 19200] arena)."""
    from repro_torch.kernels import fused_combine as fc
    from repro_torch.kernels import pack_combine as pc

    gen = torch.Generator(device=dev).manual_seed(99)
    x = torch.randn((8, 3_072_000), device=dev, generator=gen).bfloat16()
    y = torch.randn((8, 3_072_000), device=dev, generator=gen).bfloat16()
    out = torch.empty_like(x)
    comb_bytes = 3 * x.numel() * x.element_size()
    comb = {
        "ms": time_ms(lambda: fc.fused_combine(x, y, op="add")),
        "plain_ms": time_ms(lambda: fc.plain(x, y, "add")),
        "library_ms": time_ms(lambda: torch.add(x, y, out=out)),
        "bytes": comb_bytes,
        "shape": [8, 3_072_000], "dtype": "bfloat16", "op": "add",
    }
    arena = torch.zeros((8, 19200), device=dev)
    parts = [torch.randn((8, s), device=dev, generator=gen)
             for s in (768, 9216, 9216)]
    pack_bytes = 2 * sum(p.numel() for p in parts) * 4
    pack = {
        "ms": time_ms(lambda: pc.fused_pack(arena, *parts)),
        "plain_ms": time_ms(lambda: pc.plain(arena, *parts)),
        "library_ms": time_ms(lambda: torch.cat(parts, dim=-1, out=arena)),
        "bytes": pack_bytes,
        "shape": [8, 19200], "dtype": "float32", "op": None,
    }
    for t in (comb, pack):
        t["bound_ms"] = t["bytes"] / peak * 1e3
    return {"fused_combine": comb, "fused_pack": pack}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def expected_launches(compiled, mesh) -> tuple[int, int]:
    """(hop-combine launches, pack launches) one sync makes, read off the
    compiled plan: n-1 combines per ring all-reduce stage, one launch per
    arena pack."""
    hops = sum(mesh.axis_size(st.axis) - 1 for st in compiled.stages
               if st.kind in ("allreduce", "batched_allreduce"))
    packs = sum(st.arena_slot is not None for st in compiled.stages)
    return hops, packs


def main_path(mesh, cfg, seed: int, *, steps: int = 3,
              expect_kernels: bool = True) -> dict:
    from repro_torch import core as acis
    from repro_torch.configs.acis_100m import grad_leaf_specs
    from repro_torch.kernels import fused_combine as fc
    from repro_torch.kernels import pack_combine as pc

    dev = mesh.device
    cuda = dev.type == "cuda"
    sync_dev = torch.cuda.synchronize if cuda else (lambda: None)
    gen = torch.Generator(device=dev).manual_seed(seed)
    specs = grad_leaf_specs(cfg)
    grads = {k: torch.randn(mesh.rank_shape + shape, device=dev,
                            generator=gen).to(dt) for k, shape, dt in specs}
    n_params = sum(v[0].numel() for v in grads.values())
    local_bytes = sum(v[0].numel() * v.element_size()
                      for v in grads.values())
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def run(eng, arenas, n):
        ptrs = [a.data_ptr() for a in arenas]
        times, out = [], None
        for _ in range(n):
            sync_dev()
            t0 = time.perf_counter()
            out, _, back = eng.gradient_sync(grads, None, arenas=arenas,
                                             mesh=mesh)
            sync_dev()
            times.append((time.perf_counter() - t0) * 1e3)
            check(back == tuple(arenas), "sync returned other arenas")
        check([a.data_ptr() for a in arenas] == ptrs,
              "arena data_ptr changed across a sync")
        return out, times

    eng_k = acis.make_engine("acis")
    check(eng_k.config.use_kernels, "use_kernels is off by default")
    arenas_k = eng_k.init_arenas(grads, mesh=mesh)
    check(arenas_k is not None, "the sync program has no bucket arena")
    compiled = eng_k.last_sync_program()
    hops, packs = expected_launches(compiled, mesh)

    # the counts cover exactly the main path's kernel syncs
    fc.launches = 0
    pc.launches = 0
    out_k, t_k = run(eng_k, arenas_k, steps)
    launches = {"fused_combine": fc.launches, "fused_pack": pc.launches}
    if expect_kernels:
        check(launches["fused_combine"] == steps * hops,
              f"hop kernel launched {launches['fused_combine']} times, "
              f"the plan needs {steps} x {hops}")
        check(launches["fused_pack"] == steps * packs,
              f"pack kernel launched {launches['fused_pack']} times, "
              f"the plan needs {steps} x {packs}")

    eng_p = acis.make_engine("acis", use_kernels=False)
    out_p, t_p = run(eng_p, eng_p.init_arenas(grads, mesh=mesh), steps)
    for k in grads:
        check(torch.equal(out_k[k], out_p[k]),
              f"{k}: kernel sync differs from use_kernels=False")

    # The xla baseline and the f32 mean round each lane once; the ring
    # rounds its bf16 partial sum at each of its n-1 hops, by at most half
    # an ulp (2^-8 relative) of that partial sum, which is bounded by the
    # lane's sum of |g|.  After the mean a lane may differ by
    # (n-1)/2 * 2^-7 * sum|g| / n, plus one ulp of the result.
    out_x, _ = acis.make_engine("xla").gradient_sync(grads, None, mesh=mesh)
    n = mesh.axis_size("data")
    worst_x = worst_mean = 0.0
    for k in grads:
        o = out_k[k]
        check(tuple(o.shape) == tuple(grads[k].shape) and
              o.dtype == grads[k].dtype, f"{k}: wrong shape/dtype")
        check(bool(torch.isfinite(o).all()), f"{k}: non-finite output")
        mean = grads[k].float().mean(0)
        eps = 2.0 ** -7 if o.dtype == torch.bfloat16 else 2.0 ** -23
        bound = (n - 1) / 2 * eps * grads[k].abs().float().sum(0) / n \
            + eps * mean.abs()
        dx = (o.float() - out_x[k].float()).abs()
        dm = (o[0].float() - mean).abs()
        check(bool((dx <= bound + eps * out_x[k].float().abs()).all()),
              f"{k}: acis and xla differ beyond the ring's rounding")
        check(bool((dm <= bound).all()),
              f"{k}: acis and the exact mean differ beyond the ring's "
              "rounding")
        worst_x = max(worst_x, dx.max().item())
        worst_mean = max(worst_mean, dm.max().item())

    profile = device_profile(lambda: eng_k.gradient_sync(
        grads, None, arenas=arenas_k, mesh=mesh)) if cuda else None
    med_k, med_p = statistics.median(t_k), statistics.median(t_p)
    return {
        "phase": "main", "model": cfg.name, "ranks": n,
        "leaves": len(specs), "params_per_rank": n_params,
        "bytes_per_rank": local_bytes, "steps": steps,
        "stages": len(compiled.stages),
        "stage_kinds": compiled.stage_kinds(),
        "waves": compiled.plan.n_waves,
        "arena_shapes": [list(a.shape) for a in arenas_k],
        "pack_transient_bytes": compiled.pack_transient_bytes(),
        "hop_launches_per_sync": hops, "pack_launches_per_sync": packs,
        "launches": launches,
        "sync_ms_kernels": t_k, "sync_ms_plain": t_p,
        "median_sync_ms_kernels": med_k, "median_sync_ms_plain": med_p,
        "ring_algbw_GBps_kernels":
            local_bytes * 2 * (n - 1) / n / (med_k * 1e-3) / 1e9,
        "max_abs_diff_vs_xla": worst_x,
        "max_abs_diff_vs_f32_mean": worst_mean,
        "bitwise_equal_to_plain": True,
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if cuda else None),
        "profile": profile,
    }


def device_profile(step) -> dict:
    """One more kernel sync under ``torch.profiler``: device time by
    kernel name (top 10) and the device's busy share of the window (sum
    of kernel times over the host wall time, profiler overhead
    included).  A measurement only: a profiler that fails reports why."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name: dict = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    except Exception as exc:          # measurement only, never a check
        return {"error": f"{type(exc).__name__}: {exc}"}
    busy = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"window_ms": wall_us / 1e3, "device_ms": busy / 1e3,
            "device_busy_share": busy / wall_us if wall_us else None,
            "kernels": len(by_name),
            "top": [{"name": n[:90], "ms": t / 1e3, "count": c}
                    for n, (t, c) in top]}


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every phase's record to this JSON file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.configs.acis_100m import CONFIG
    from repro_torch.kernels import build
    from repro_torch.mesh import LocalMesh

    records = []
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    peak, peak_note = hbm_peak(name)
    nvcc_v = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip()
    rec = {"phase": "env", "torch": torch.__version__,
           "cuda": torch.version.cuda, "python": sys.version.split()[0],
           "nvidia_smi": smi, "device": name,
           "device_count": torch.cuda.device_count(),
           "nvcc": nvcc_v.splitlines()[-1],
           "ninja_on_path": shutil.which("ninja") is not None,
           "hbm_peak_Bps": peak, "hbm_peak_source": peak_note}
    emit(rec)
    records.append(rec)

    t0 = time.perf_counter()
    built = build.build()
    rec = {"phase": "build", "seconds": time.perf_counter() - t0,
           "cache_hit": all(b["hit"] for b in built.values()),
           "ptxas": {k: [ln.strip() for ln in b["ptxas"].splitlines()
                         if "registers" in ln]
                     for k, b in built.items()}}
    emit(rec)
    records.append(rec)

    dev = torch.device("cuda")
    checks = kernel_checks(dev)
    timings = kernel_timings(dev, peak)
    rec = {"phase": "kernels", "checks": checks, "timings": timings}
    emit(rec)
    records.append(rec)

    mesh = LocalMesh({"data": 8}, device="cuda")
    rec = main_path(mesh, CONFIG, args.seed)
    emit(rec)
    records.append(rec)

    sources = {"fused_combine": ("src/repro_torch/kernels/csrc/"
                                 "fused_combine.cu",
                                 "src/repro/kernels/fused_combine.py:70"),
               "fused_pack": ("src/repro_torch/kernels/csrc/fused_pack.cu",
                              "src/repro/kernels/pack_combine.py:68")}
    kernels = []
    for k, (src, replaces) in sources.items():
        t = timings[k]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": rec["launches"][k],
            "max_abs_err": checks[k]["max_abs_err"],
            "max_err": checks[k]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": t["library_ms"]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"records": records, "kernels": kernels}, indent=1))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
