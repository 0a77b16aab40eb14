#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--out chiprun_out/chip_smoke.json]

Phases, one JSON line each:

  1. env        — torch / CUDA versions, the card's name and power limit,
                  nvcc, ninja
  2. build      — builds every CUDA kernel from ``src/repro_torch/kernels/
                  csrc`` (one nvcc per source, all at once)
  3. kernels    — each kernel against its plain PyTorch version on the
                  card (bitwise, ``fused_hop`` against the ring step it
                  replaces for every hop of a ring of 8, on one axis and
                  over the second of two, and of both rings of pod 2 x
                  data 4 (``HOP_VIEWS``); bf16 ``mac`` within one bf16 ulp;
                  ``topk_accumulate`` with duplicate indices within f32
                  rounding of the lane's sum; ``prefix_sum`` bitwise on
                  integer-valued data, within ``scan_tolerance`` of the
                  exact sum on random data, its run-to-run differences
                  reported; ``quant_combine`` and its ring-hop form
                  ``quant_hop`` bitwise, the hop for every hop of a ring of
                  8 on one axis and over the second of two, exact rows and
                  a NaN row included, and of both rings of pod 2 x data 4;
                  ``rwkv6_recurrence`` within
                  ``wkv_tolerance`` of the float64 recurrence, as its
                  plain version is; ``rglru_scan`` bitwise, and both
                  within ``rglru_tolerance``), then timed at the main
                  path's shapes with CUDA events beside its plain version,
                  one PyTorch library call computing the same function
                  where there is one, and its bound (bytes over the
                  memory rate, or f32 operations over the f32 rate)
  4. acis       — the acis-100m gradient sync at full width (12 leaves,
                  124,668,672 parameters per rank, 8 ranks on one
                  ``LocalMesh``): ``make_engine("acis")`` with kernels on,
                  ``init_arenas``, one untimed warm-up sync per engine,
                  then 3 timed syncs in turns with the same sync at
                  ``use_kernels=False`` (which goes first alternates);
                  bitwise equal to it, within bf16
                  rounding of the ``xla`` backend and of the exact f32
                  mean; arenas written in place; every ring hop launched
                  ``fused_hop`` and every bucket pack ``fused_pack``, as
                  often as the compiled plan says; a profile of one sync
                  each way, its rolls and gathers counted
  5. compressed — ``make_engine("acis_compressed", compressor=c)`` for c
                  in int8, int8_hopquant, topk at the same width:
                  ``init_state``, ``init_arenas``, a warm-up sync per
                  engine, then 3 steps with the EF residual threaded,
                  in turns with ``use_kernels=False`` as above; outputs and
                  residuals bitwise equal to it, every rank holding the
                  same totals, the EF identity over the 3 steps, and
                  ``quant_hop`` / ``topk_accumulate`` launched as
                  often as the compiled program says; a profile of one
                  sync each way, its rolls and gathers counted
  6. fused      — the Type 3/4 programs through ``make_engine("acis").
                  compile`` on ``LocalMesh({"data": 8})``, one line each:
                  Fig. 5's scan + gather at 4 MiB per rank (1-D and
                  [16384, 64]; its local scan the prefix_sum kernel), NAS IS
                  class C (histogram all-reduce + key all-to-all), map +
                  reduce-scatter and all-gather + map, GCN aggregation at
                  Pubmed's size in-network and as all-gather + SpMM, and
                  rank-4 PowerSGD of one acis-100m MLP matrix; one untimed
                  call, then 3 timed calls in turns with
                  ``use_kernels=False``, each output held against an exact
                  or float64 result within its stated bound, and
                  ``prefix_sum`` launched as often as the programs say
                  (``fused_path``)
  7. hierarchical — the same acis-100m gradients on ``LocalMesh({"pod":
                  2, "data": 4})``: ``acis_hierarchical`` as the acis
                  phase (reduce-scatter over data, all-reduce over pod,
                  all-gather; ``fused_hop`` on both axes), plus one
                  sync with ``overlap_dispatch=False`` bitwise equal to
                  the overlapped one (whose multi-axis waves run on a
                  CUDA stream per axis) and the mean within twice the
                  ring bound of the flat ``acis`` sync on ``{"data":
                  8}``; ``acis_hierarchical_compressed`` with each
                  compressor as the compressed phase; then F2's program,
                  ``reduce(axis="auto")`` through the compressed engine's
                  ``compile`` with the int8 codec on the pod hop
                  (``quant_hop``), kernels against plain bitwise and
                  within the int8 bound of the exact sum
                  (``hierarchical_path``).  Each record carries the
                  compile ms (PlaceCGRA included) and the cost model's
                  ``program_time`` for the paper's switch, which is not a
                  time on the card
  8. sim        — ``SwitchSim`` (``repro_torch.cgra.simulate``) on the card
                  at the same width: the compiled ``acis`` sync on
                  {data: 8}, ``acis_hierarchical`` on {data: 4, pod: 2},
                  ``acis_compressed`` with ``int8_hopquant`` and with
                  ``topk``, the masked ``acis`` sync under
                  ``FaultPlan(dead={3})``, and Fig. 5's inclusive-add scan
                  at 4 MiB a rank; each run with kernels and with
                  ``use_kernels=False`` in turns, held to the executed
                  program (bitwise; ``topk`` within n·2^-24·Σ|v| of the
                  exact total, the scan within ``scan_tolerance``), its
                  ``fused_combine`` / ``quant_combine`` / ``topk_accumulate``
                  / ``prefix_sum`` launches as the plan predicts
                  (``sim_path``); the report's times are the cost model's
  9. tune       — ``record_instrumented`` of the ``acis`` and
                  ``acis_hierarchical`` syncs (CUDA-event spans), 3 runs
                  each, ``fit_traces`` (a fit of this card) and ``replay``
                  against the measured ``t_end``, a Chrome trace written and
                  parsed back, the drift watchdog, and ``autotune`` through
                  a temporary tuning DB: search once, hit the DB after
                  (``tune_path``)
  10. elastic   — ``gradient_sync(membership=...)`` with rank 3 of 8
                  dropped on ``acis`` and ``acis_hierarchical``: kernels
                  against plain bitwise, within the ring bound of the live
                  mean, masked and unmasked ms in turns, ``recompile``
                  reusing program and arenas; one ``sync_with_deadline``
                  over ``SwitchSim`` rank times with a straggler, masked on
                  one retry (``elastic_path``)
  11. serve      — rwkv6-1.6b at full width and depth (24 layers, d_model
                  2048, 32 heads of 64, d_ff 7168, vocab 65,536) on seeded
                  random bf16 weights made on the card: ``Model.prefill``
                  of 8 prompts of 512 tokens and 32 greedy
                  ``decode_step``s, kernels on and ``use_kernels=False``
                  in turns after a warm-up, logits held within
                  ``BF16_REL``; a 64-token prefill held against 64 decode
                  steps; a profile of one prefill and one decode step;
                  ``ServeEngine(slots=4)`` over 8 requests, each
                  completion held against a fresh one-slot engine's; then
                  the same checks on the weights cast to f32 within
                  ``F32_REL`` (``serve_path``); ``rwkv6_recurrence``
                  launched once per layer per prefill call, decode step
                  and engine tick
  12. serve_hybrid — recurrentgemma-9b at full width and depth (38 layers:
                  12 x (lru, lru, window) + (lru, lru); d_model 4096, 16
                  query heads and 1 KV head of 256, lru_width 4096, conv
                  width 4, window 2048, d_ff 12288 GeGLU, vocab 256,000)
                  through the same checks, plus 2 prompts of 2,560 tokens
                  (past the window) and 16 decode steps, kernels against
                  plain; ``rglru_scan`` launched once per lru layer (26)
                  per prefill call, decode step and engine tick

Each path's launch counts are set to 0 just before it runs and read just
after; launches made to compare a kernel with its plain version are not
counted.  Then the ``{"kernels": [...]}`` line, the card's name and
power limit as ``nvidia-smi`` reports them, and, last, ``{"ok": true,
"device": ...}``.
Any failed check raises: the exit code is non-zero and no ``ok`` line is
printed.  Without a CUDA device, or without the repository around it, the
script stops before any phase.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

ROOT = Path(__file__).resolve().parent

# device-memory and float32 (outside the tensor cores) peaks by card name
# (NVIDIA data sheets): the bound_ms denominators.
PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, "H100 PCIe: 2.0 TB/s HBM2e, 51 TFLOP/s f32"),
    ("H100", 3.35e12, 67e12, "H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s f32"),
    ("H200", 4.8e12, 67e12, "H200: 4.8 TB/s HBM3e, 67 TFLOP/s f32"),
)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_peaks(name: str) -> tuple[float, float, str]:
    """``(bytes/s, f32 flop/s, source)`` of the card called ``name``."""
    for key, hbm, f32, note in PEAKS:
        if key in name:
            return hbm, f32, note
    raise RuntimeError(f"no peak rates known for {name!r}")


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
# the kernels' launch counts
# ---------------------------------------------------------------------------

def kernel_modules() -> dict:
    """Every ported kernel's wrapper module and the name of its launch
    count there, by kernel name (``fused_combine``, ``quant_combine`` and
    ``chunk_scan`` hold two kernels each)."""
    from repro_torch.kernels import (chunk_scan, fused_combine, pack_combine,
                                     quant_combine, rwkv6_recurrence,
                                     topk_accum)
    return {"fused_combine": (fused_combine, "launches"),
            "fused_hop": (fused_combine, "hop_launches"),
            "fused_pack": (pack_combine, "launches"),
            "quant_combine": (quant_combine, "launches"),
            "quant_hop": (quant_combine, "hop_launches"),
            "topk_accumulate": (topk_accum, "launches"),
            "prefix_sum": (chunk_scan, "launches"),
            "rwkv6_recurrence": (rwkv6_recurrence, "launches"),
            "rglru_scan": (chunk_scan, "rglru_launches")}


def reset_counts() -> None:
    for m, attr in kernel_modules().values():
        setattr(m, attr, 0)


def read_counts() -> dict:
    return {k: getattr(m, attr) for k, (m, attr) in kernel_modules().items()}


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
            torch.int8: torch.int8, torch.int32: torch.int32}[got.dtype]
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

    # pack: ragged parts, a tail past the parts that must survive, in
    # place; 130 parts take two launches of the by-value table
    many = tuple((7 * k) % 61 for k in range(130))
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for op in (None, "add", "max", "min"):
            for rows, sizes_, tail in (((8,), (768, 9216, 9216), 0),
                                       ((8,), (1, 100, 0, 3333), 7),
                                       ((), (5,), 3), ((8,), many, 5)):
                arena = data(rows + (sum(sizes_) + tail,), dtype)
                if op and dtype != torch.int8 and arena.numel() > 8:
                    arena.view(-1)[2] = float("nan")
                parts = [data(rows + (s,), dtype) for s in sizes_]
                want = pc.plain(arena.clone(), *parts, op=op)
                ptr = arena.data_ptr()
                before = arena[..., sum(sizes_):].clone()
                n0 = pc.launches
                got = pc.fused_pack(arena, *parts, op=op)
                torch.cuda.synchronize()
                check(got is arena and arena.data_ptr() == ptr,
                      "pack did not write the arena in place")
                groups = -(-sum(1 for k in sizes_ if k) // pc.MAX_PARTS)
                check(pc.launches - n0 == groups,
                      f"a pack of {len(sizes_)} parts made "
                      f"{pc.launches - n0} launches, not {groups}")
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
    report["fused_pack"]["max_parts_per_launch"] = pc.MAX_PARTS
    report["fused_hop"] = hop_checks(dev, gen, data)
    report["fused_hop"]["fp8_wire"] = fp8_hop_checks(dev, gen)
    report["quant_combine"] = quant_checks(dev, gen)
    report["quant_hop"] = quant_hop_checks(dev, gen)
    report["topk_accumulate"] = topk_checks(dev, gen)
    report["prefix_sum"] = prefix_checks(dev, gen)
    report["rwkv6_recurrence"] = wkv_checks(dev, gen)
    report["rglru_scan"] = rglru_checks(dev, gen)
    return report


HOP_VIEWS = (({"data": 8}, "data"), ({"pod": 2, "data": 8}, "data"),
             ({"pod": 2, "data": 4}, "data"), ({"pod": 2, "data": 4}, "pod"))


def hop_checks(dev, gen, data) -> dict:
    """``fused_hop`` against the ring step it replaces, ``combine(
    tp.shift(buf, 1), tp.take(xs, (i - 2 - s) % n))``, bit for bit: f32,
    bf16 and int8, add/max/min (NaN lanes planted for floats), every hop
    ``s`` of a ring of 8 on ``LocalMesh({"data": 8})`` and over the second
    axis of ``{"pod": 2, "data": 8}``, and of both rings of the
    hierarchical mesh ``{"pod": 2, "data": 4}``, at a chunk that takes the
    scalar lanes (1003) and one that takes the vectors (4096); then every
    hop of the largest acis-100m ring (bf16 add, chunk 3,072,000)."""
    from repro_torch.kernels import fused_combine as fc
    from repro_torch.kernels import ref
    from repro_torch.mesh import LocalMesh

    report = {"cases": 0, "max_abs_err": 0.0}

    def hold(mesh, buf, xs, op, ax="data"):
        i, n = mesh.axis_index(ax), mesh.axis_size(ax)
        for s in range(n - 1):
            got = fc.fused_hop(buf, xs, s, dim=mesh.dim(ax),
                               rank_ndim=mesh.rank_ndim, op=op)
            want = ref.COMBINES[op](mesh.shift(buf, ax, 1),
                                    mesh.take(xs, (i - 2 - s) % n))
            torch.cuda.synchronize()
            report["cases"] += 1
            report["max_abs_err"] = max(report["max_abs_err"],
                                        _bitwise_err(got, want))

    # the flat ring, the second axis of two, and the hierarchical views:
    # data of pod 2 x data 4 ([A, n, B] = [2, 4, chunk]) and pod ([1, 2,
    # 4 x chunk])
    for axes, ax in HOP_VIEWS:
        mesh = LocalMesh(axes, device=dev)
        n = mesh.axis_size(ax)
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            for op in ("add", "max", "min"):
                for chunk in (1003, 4096):
                    xs = data(mesh.rank_shape + (n, chunk), dtype)
                    buf = data(mesh.rank_shape + (chunk,), dtype)
                    if op != "add" and dtype != torch.int8:
                        xs.view(-1)[5::97] = float("nan")
                        buf.view(-1)[3::89] = float("nan")
                    hold(mesh, buf, xs, op, ax)
    mesh = LocalMesh({"data": 8}, device=dev)
    xs = data((8, 8, 3_072_000), torch.bfloat16)
    hold(mesh, xs[:, 0].clone(), xs, "add")
    return report


def fp8_hop_checks(dev, gen) -> dict:
    """F3: an fp8 wire's ring hop with kernels on.  ``switchops.
    hop_kernel``'s combine and its fused hop compute in f32 through the
    kernels and round once to the fp8 dtype: bitwise the monoid's own
    (widening) combine, and the plain ring step in f32 rounded to fp8, for
    every hop of a ring of 8, both fp8 formats, add and max."""
    from repro_torch.core import switchops
    from repro_torch.core.types import TYPE1_MONOIDS
    from repro_torch.kernels import fused_combine as fc

    def same(got, want, what):
        check(got.dtype == want.dtype and torch.equal(
            got.view(torch.uint8), want.view(torch.uint8)),
            f"fp8 {what}: differs from the widening combine")

    cases = 0
    for dt in (torch.float8_e4m3fn, torch.float8_e5m2):
        for name in ("add", "max"):
            hop = switchops.hop_kernel(name)
            x, y = ((torch.randn((8, 3000), device=dev, generator=gen) * 4)
                    .to(dt) for _ in range(2))
            same(hop(x, y), TYPE1_MONOIDS[name].combine(x, y),
                 f"{name} combine")
            xs = (torch.randn((8, 8, 3000), device=dev, generator=gen) * 4) \
                .to(dt)
            buf = xs[:, 1].contiguous()
            for s in range(7):
                got = hop.fused_hop(buf, xs, s, dim=0, rank_ndim=1)
                want = fc.hop_plain(buf.float(), xs.float(), s, dim=0,
                                    rank_ndim=1, op=name).to(dt)
                same(got, want, f"{name} hop {s}")
                buf = got
            cases += 8
    return {"cases": cases, "bitwise": True}


def quant_cases(dev, gen) -> tuple[list, list]:
    """Random payloads at a few row counts (rank dims in front), and six
    rows with exact products: .5 ties (row 0, scale 1.0), an all-zero
    row, zero scales, saturation at +127 and -127, unequal scales."""
    def rnd(rows):
        def q():
            return torch.randint(-127, 128, rows + (256,), device=dev,
                                 generator=gen, dtype=torch.int8)

        def s():
            return torch.rand(rows, device=dev, generator=gen) * 2
        return [q(), s(), q(), s()]

    qa, sa, qb, sb = rnd((6,))
    sa.fill_(0.5)
    sb.fill_(0.5)
    qa[0] = torch.randint(-60, 61, (256,), device=dev, generator=gen,
                          dtype=torch.int8)
    qb[0] = torch.randint(-60, 61, (256,), device=dev, generator=gen,
                          dtype=torch.int8)
    qa[0, 0] = qb[0, 0] = 127
    qa[0, 1:7] = torch.tensor([1, 2, 3, -1, -2, -3], dtype=torch.int8)
    qb[0, 1:7] = torch.tensor([0, 1, 2, 0, -1, -2], dtype=torch.int8)
    qa[1] = qb[1] = 0
    sa[2] = sb[2] = 0.0
    qa[3] = qb[3] = 127
    qa[4] = qb[4] = -127
    sa[5], sb[5] = 2.0, 0.25
    return [rnd((1,)), rnd((7,)), rnd((8, 1500))], [qa, sa, qb, sb]


def quant_checks(dev, gen) -> dict:
    from repro_torch.kernels import quant_combine as qc

    randoms, exact = quant_cases(dev, gen)
    r = {"cases": 0, "max_abs_err": 0.0}
    for qa, sa, qb, sb in randoms + [exact]:
        q, s = qc.quant_combine(qa, sa, qb, sb)
        wq, ws = qc.plain(qa, sa, qb, sb)
        torch.cuda.synchronize()
        r["max_abs_err"] = max(r["max_abs_err"], _bitwise_err(q, wq),
                               _bitwise_err(s, ws))
        r["cases"] += 1
    q, s = qc.quant_combine(*exact)
    check(q[0, 1:7].tolist() == [0, 2, 2, 0, -2, -2],
          f"the .5 ties did not round half to even: {q[0, 1:7].tolist()}")
    check(s[1].item() == s[2].item() == 1.0 and not q[1:3].any(),
          "a zero row must get scale 1.0 and q 0")
    check(bool((q[3] == 127).all() and (q[4] == -127).all()),
          "saturated rows must hold ±127")
    # a NaN scale: the plain version's absmax is NaN, so where(absmax > 0)
    # gives scale 1.0; the kernel propagates NaN through its absmax to the
    # same 1.0 and writes the row's NaN lanes as 0
    qa, sa, qb, sb = [t.clone() for t in exact]
    sa[3] = float("nan")
    q, s = qc.quant_combine(qa, sa, qb, sb)
    wq, ws = qc.plain(qa, sa, qb, sb)
    torch.cuda.synchronize()
    check(s[3].item() == 1.0 and ws[3].item() == 1.0,
          f"NaN row scale {s[3].item()} (plain {ws[3].item()}), expected 1.0")
    check(not q[3].any(), "the NaN row's lanes must be written as 0")
    keep = torch.arange(6, device=dev) != 3
    _bitwise_err(q[keep], wq[keep])
    _bitwise_err(s, ws)
    r["nan_row"] = {"scale": s[3].item(), "kernel_q_zero": True,
                    "plain_q_equal": bool(torch.equal(q[3], wq[3]))}
    r["cases"] += 1
    return r


def quant_hop_checks(dev, gen, big_rows: int = 12_000) -> dict:
    """``quant_hop`` against its plain version (``quant_hop_plain``), bit
    for bit, and against the ring step it replaces, ``quant_combine(
    tp.shift(buf, 1), tp.take(xs, (i - 2 - s) % n))``: every hop ``s`` of
    a ring of 8 on ``LocalMesh({"data": 8})`` and over the second axis of
    ``{"pod": 2, "data": 8}``, at ragged row counts (1, 7, 1003) of random
    rows; then the six exact rows of :func:`quant_cases` in every rank's
    partial sum and chunk (the .5 ties, a zero row, zero scales, ±127,
    unequal scales), once more with a NaN scale in row 3 (its lanes held
    to 0, the plain version's compared elsewhere); every hop of both rings
    of ``{"pod": 2, "data": 4}`` at the same random row counts; then every
    hop of the largest int8_hopquant ring (``big_rows`` rows a chunk)."""
    from repro_torch.kernels import quant_combine as qc
    from repro_torch.mesh import LocalMesh

    r = {"cases": 0, "max_abs_err": 0.0}

    def rnd(shape):
        return (torch.randint(-127, 128, shape + (256,), device=dev,
                              generator=gen, dtype=torch.int8),
                torch.rand(shape, device=dev, generator=gen) * 2)

    def hold(mesh, buf, xs, nan_row=None, ax="data"):
        i, n = mesh.axis_index(ax), mesh.axis_size(ax)
        for s in range(n - 1):
            kw = dict(dim=mesh.dim(ax), rank_ndim=mesh.rank_ndim)
            q, sc = qc.quant_hop(*buf, *xs, s, **kw)
            wq, ws = qc.hop_plain(*buf, *xs, s, **kw)
            torch.cuda.synchronize()
            if nan_row is None:
                r["max_abs_err"] = max(r["max_abs_err"], _bitwise_err(q, wq),
                                       _bitwise_err(sc, ws))
                tq, ts = qc.plain(mesh.shift(buf[0], ax, 1),
                                  mesh.shift(buf[1], ax, 1),
                                  mesh.take(xs[0], (i - 2 - s) % n),
                                  mesh.take(xs[1], (i - 2 - s) % n))
                _bitwise_err(q, tq)
                _bitwise_err(sc, ts)
            else:
                check(bool((sc[..., nan_row] == 1.0).all()
                           and (ws[..., nan_row] == 1.0).all()),
                      "a NaN row must get scale 1.0")
                check(not q[..., nan_row, :].any(),
                      "the NaN row's lanes must be written as 0")
                keep = torch.arange(q.shape[-2], device=dev) != nan_row
                _bitwise_err(q[..., keep, :], wq[..., keep, :])
                _bitwise_err(sc, ws)
            r["cases"] += 1
        return q, sc

    _, (qa, sa, qb, sb) = quant_cases(dev, gen)
    for axes in ({"data": 8}, {"pod": 2, "data": 8}):
        mesh = LocalMesh(axes, device=dev)
        for rows in (1, 7, 1003):
            hold(mesh, rnd(mesh.rank_shape + (rows,)),
                 rnd(mesh.rank_shape + (8, rows)))
        buf = (qa.expand(mesh.rank_shape + qa.shape).contiguous(),
               sa.expand(mesh.rank_shape + sa.shape).contiguous())
        xs = (qb.expand(mesh.rank_shape + (8,) + qb.shape).contiguous(),
              sb.expand(mesh.rank_shape + (8,) + sb.shape).contiguous())
        q, sc = hold(mesh, buf, xs)
        check(q[..., 0, 1:7].eq(torch.tensor(
            [0, 2, 2, 0, -2, -2], dtype=torch.int8, device=dev)).all().item(),
            "the .5 ties did not round half to even")
        check(bool((sc[..., 1:3] == 1.0).all() and not q[..., 1:3, :].any()),
              "a zero row must get scale 1.0 and q 0")
        check(bool((q[..., 3, :] == 127).all() and (q[..., 4, :] == -127)
                   .all()), "saturated rows must hold ±127")
        nan_buf = (buf[0], buf[1].clone())
        nan_buf[1][..., 3] = float("nan")
        hold(mesh, nan_buf, xs, nan_row=3)
    for axes, ax in HOP_VIEWS[2:]:          # the hierarchical mesh's rings
        mesh = LocalMesh(axes, device=dev)
        n = mesh.axis_size(ax)
        for rows in (1, 7, 1003):
            hold(mesh, rnd(mesh.rank_shape + (rows,)),
                 rnd(mesh.rank_shape + (n, rows)), ax=ax)
    mesh = LocalMesh({"data": 8}, device=dev)
    hold(mesh, rnd((8, big_rows)), rnd((8, 8, big_rows)))
    r["nan_row"] = {"scale": 1.0, "kernel_q_zero": True}
    return r


def topk_checks(dev, gen) -> dict:
    """Distinct indices per row (the path's case): bitwise and in place.
    Out-of-range indices: dropped by both.  Duplicates: the atomics add
    in the hardware's order, so a lane with d adds agrees with the plain
    version within d·2^-23·(|dense| + Σ|vals|) at that lane."""
    from repro_torch.core.compression import sparse_accumulate
    from repro_torch.kernels import topk_accum as ta

    def distinct(rows, size, k):
        return torch.stack([torch.randperm(size, device=dev,
                                           generator=gen)[:k]
                            for _ in range(rows)]).to(torch.int32)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    r = {"cases": 0, "max_abs_err": 0.0}
    cases = []
    for rows, size, k in ((1, 1000, 10), (8, 100_000, 1000),
                          (8, 1_536_000, 15_360)):
        cases.append((randn(rows, size), distinct(rows, size, k),
                      randn(rows, k)))
    d, i, v = randn(1, 3000), distinct(1, 3000, 30), randn(1, 30)
    cases.append((d[0], i[0], v[0]))                     # the 1-D form
    d, i, v = randn(8, 5000), distinct(8, 5000, 100), randn(8, 100)
    i[:, 0], i[:, 1], i[:, 2] = -1, 5000, 1 << 30        # out of range
    cases.append((d, i, v))
    for dense, idx, vals in cases:
        want = ta.plain(dense.clone(), idx, vals)
        ptr = dense.data_ptr()
        got = ta.topk_accumulate_(dense, idx, vals)
        torch.cuda.synchronize()
        check(got is dense and dense.data_ptr() == ptr,
              "topk_accumulate did not update the accumulator in place")
        r["max_abs_err"] = max(r["max_abs_err"], _bitwise_err(got, want))
        r["cases"] += 1
    dense, vals = randn(8, 64), randn(8, 4096)
    idx = torch.randint(0, 64, (8, 4096), device=dev, generator=gen,
                        dtype=torch.int32)
    want = ta.plain(dense.clone(), idx, vals)
    absum = ta.plain(dense.abs(), idx, vals.abs())
    mult = max(int(torch.bincount(row.long()).max()) for row in idx)
    got = ta.topk_accumulate_(dense, idx, vals)
    torch.cuda.synchronize()
    err = (got - want).abs()
    check(bool((err <= mult * 2.0 ** -23 * absum).all()),
          f"duplicates differ by {err.max().item()} beyond f32 rounding")
    r["duplicates"] = {"max_adds_per_lane": mult,
                       "max_abs_err": err.max().item(),
                       "tolerance": "d*2^-23*(|dense|+sum|vals|) per lane"}
    r["max_abs_err"] = max(r["max_abs_err"], err.max().item())
    r["cases"] += 1
    # a payload over a row's whole range: duplicates far apart in the
    # accumulator (and next to each other), out-of-range indices among
    # them, k not a multiple of 4
    rows, size, k = 4, 3_000_000, 40_003
    dense, vals = randn(rows, size), randn(rows, k)
    idx = torch.randint(0, size, (rows, k), device=dev, generator=gen,
                        dtype=torch.int32)
    idx[:, 1::97] = idx[:, 0:1]                          # one lane, many adds
    idx[:, 2::101] = torch.tensor([-1, size, 1 << 30, -(1 << 31)],
                                  device=dev, dtype=torch.int32)[:, None]
    keep = (idx >= 0) & (idx < size)
    want = ta.plain(dense.clone(), idx, vals)
    absum = ta.plain(dense.abs(), idx, vals.abs())
    mult = max(int(torch.bincount(row[m].long()).max())
               for row, m in zip(idx, keep))
    got = ta.topk_accumulate_(dense, idx, vals)
    torch.cuda.synchronize()
    err = (got - want).abs()
    check(bool((err <= mult * 2.0 ** -23 * absum).all()),
          f"spread duplicates differ by {err.max().item()} beyond f32 "
          "rounding")
    r["spread"] = {"shape": [rows, size], "k": k, "max_adds_per_lane": mult,
                   "dropped": int((~keep).sum()),
                   "max_abs_err": err.max().item()}
    r["max_abs_err"] = max(r["max_abs_err"], err.max().item())
    r["cases"] += 1
    dense = torch.zeros(10, device=dev)
    before = ta.launches
    out = sparse_accumulate(dense, torch.tensor([1, 2], device=dev,
                                                dtype=torch.int32),
                            torch.ones(2, device=dev), use_kernels=True)
    torch.cuda.synchronize()
    check(ta.launches == before + (torch.device(dev).type == "cuda"),
          "the registry's topk_accumulate did not launch the kernel")
    check(not dense.any() and out.sum().item() == 2.0,
          "the functional form must leave its input as it was")
    return r


def scan_tolerance(x: torch.Tensor, dim: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(exact, tol)``: the float64 prefix sum of ``x`` along ``dim``, and
    the bound a float32 scan of random-sign data meets, in any order.

    Output i of a scan is an addition tree of i additions; each rounds by
    at most 2^-24 of its result, the sum of a contiguous run, which is at
    most 2·M_i (M_i = max over t <= i of |exact_t|).  On random-sign data
    the roundings are zero-mean and independent, so their sum has a
    standard deviation below sqrt(i)·2^-24·2·M_i/sqrt(3); the bound allows
    about seven of them, 2^-21·sqrt(i+1)·M_i, plus the output's own
    rounding to x's dtype (2^-24 of it for float32, 2^-8 for bfloat16).
    The worst case, i·2^-24·Σ|x_t|, is too loose to see a tile's carry
    go missing; this bound is not (tests/test_torch_chip_smoke.py)."""
    exact = torch.cumsum(x.double(), dim)
    m = torch.cummax(exact.abs(), dim).values
    shape = [1] * x.dim()
    shape[dim] = x.shape[dim]
    i = torch.arange(1, x.shape[dim] + 1, device=x.device,
                     dtype=torch.float64).reshape(shape)
    out_u = 2.0 ** -8 if x.dtype == torch.bfloat16 else 2.0 ** -24
    return exact, 2.0 ** -21 * i.sqrt() * m + out_u * exact.abs()


def scan_err(got: torch.Tensor, exact: torch.Tensor, tol: torch.Tensor,
             what: str) -> float:
    """The largest |got - exact| over its bound; raises above 1."""
    err = (got.double() - exact).abs()
    ratio = (err / tol.clamp_min(1e-300)).max().item()
    check(bool((err <= tol).all()),
          f"{what}: {err.max().item()} off the exact prefix sum, "
          f"{ratio:.3g} x its stated bound")
    return ratio


def bounded_walk(shape, dim: int, dev, gen) -> torch.Tensor:
    """bfloat16 steps in {-1, 0, 1} of a walk that stays in [0, 128] along
    ``dim`` (a triangle wave of a random walk): every sum of a contiguous
    run lies in [-128, 128], exact in bfloat16, so any scan order agrees
    bit for bit."""
    c = torch.cumsum(torch.randint(-1, 2, shape, device=dev, generator=gen),
                     dim)
    f = 128 - (c.remainder(256) - 128).abs()
    return torch.diff(f, dim=dim, prepend=torch.zeros_like(
        f.narrow(dim, 0, 1))).to(torch.bfloat16)


def prefix_checks(dev, gen) -> dict:
    """f32 at the fused path's shapes ([8, 2^20], [8, 16384, 64]), a ragged
    T, lanes that fill no warp, T = 1 and one long row: integer-valued data
    (every partial sum exact) bitwise equal to the plain version and to the
    exact sum; random normal data within :func:`scan_tolerance` of the
    exact sum, kernel and plain version alike, so within twice it of each
    other.  bf16: a bounded walk bitwise; random data within the bf16
    bound of the exact sum (the plain version's difference is reported,
    not held: its bf16 accumulation is PyTorch's own).  The look-back
    makes a float scan's last bits depend on which tiles had published:
    the elements that differ between two runs on one random [8, 2^20]
    input are counted, not held."""
    from repro_torch.kernels import chunk_scan as cs

    r = {"cases": 0, "max_abs_err": 0.0, "max_err_over_bound": 0.0}
    f32 = [((8, 1 << 20), 1), ((8, 16384, 64), 1), ((8, 3 * 8192 + 123), 1),
           ((3, 1000, 5), 1), ((4, 3000, 7), 1), ((8, 1, 64), 1),
           ((5, 1), 1), ((100003,), 0)]
    for shape, dim in f32:
        x = torch.randint(-1, 2, shape, device=dev, generator=gen).float()
        got, want = cs.prefix_sum(x, dim), cs.plain(x, dim)
        torch.cuda.synchronize()
        _bitwise_err(got, want)
        check(torch.equal(got.double(), torch.cumsum(x.double(), dim)),
              f"prefix_sum {shape}: integer-valued scan not exact")
        x = torch.randn(shape, device=dev, generator=gen)
        got, want = cs.prefix_sum(x, dim), cs.plain(x, dim)
        torch.cuda.synchronize()
        exact, tol = scan_tolerance(x, dim)
        ratio = max(scan_err(got, exact, tol, f"prefix_sum {shape}"),
                    scan_err(want, exact, tol, f"plain cumsum {shape}"))
        diff = (got - want).abs()
        check(bool((diff <= 2 * tol).all()),
              f"prefix_sum {shape}: kernel and plain differ by "
              f"{diff.max().item()}, beyond twice the bound")
        r["max_abs_err"] = max(r["max_abs_err"], diff.max().item())
        r["max_err_over_bound"] = max(r["max_err_over_bound"], ratio)
        r["cases"] += 2
        if shape == (8, 1 << 20):
            again = cs.prefix_sum(x, dim)
            torch.cuda.synchronize()
            r["run_to_run_differing_elements"] = int((again != got).sum())
    r["bf16_plain_max_abs_diff"] = r["bf16_err_over_bound"] = 0.0
    for shape, dim in (((8, 3 * 8192 + 123), 1), ((8, 16384, 64), 1)):
        x = bounded_walk(shape, dim, dev, gen)
        got, want = cs.prefix_sum(x, dim), cs.plain(x, dim)
        torch.cuda.synchronize()
        _bitwise_err(got, want)
        x = torch.randn(shape, device=dev, generator=gen).bfloat16()
        got, want = cs.prefix_sum(x, dim), cs.plain(x, dim)
        torch.cuda.synchronize()
        exact, tol = scan_tolerance(x, dim)
        # near 1 by design: a bf16 output rounds by up to half an ulp,
        # 2^-8 of it, which the bound allows and no more
        r["bf16_err_over_bound"] = max(
            r["bf16_err_over_bound"],
            scan_err(got, exact, tol, f"bf16 prefix_sum {shape}"))
        r["bf16_plain_max_abs_diff"] = max(
            r["bf16_plain_max_abs_diff"],
            (got.float() - want.float()).abs().max().item())
        r["cases"] += 2
    for bad, err in ((torch.zeros(8, 6, device=dev).t(), ValueError),
                     (torch.zeros(8, dtype=torch.int32, device=dev),
                      TypeError)):
        if torch.device(dev).type != "cuda":
            break                 # a CPU tensor takes the plain version
        try:
            cs.prefix_sum(bad, 0)
        except err:
            continue
        raise AssertionError(f"prefix_sum took a {bad.dtype} "
                             f"{tuple(bad.stride())}-strided tensor")
    r["tolerance"] = ("random f32: 2^-21*sqrt(i+1)*max_{t<=i}|S_t| + "
                      "2^-24*|S_i| of the exact S (2^-8*|S_i| for bf16)")
    return r


def wkv_inputs(dev, gen, b: int, t: int, h: int, k: int, v: int,
               dtype=torch.bfloat16, *, model_w: bool = True) -> list:
    """r, k, v (``dtype``), w (f32) in the model's ``[B, T, H, ·]`` layout
    passed as ``[B, H, T, ·]`` views, and u ``[H, K]``.  ``model_w``: the
    decay near init, exp(-exp(-6 + 0.5·N)) ≈ 0.9975; else U(0.5, 1) as the
    reference sweep draws it."""
    def act(width):
        return (0.5 * torch.randn((b, t, h, width), device=dev,
                                  generator=gen)).to(dtype).transpose(1, 2)
    if model_w:
        w = torch.exp(-torch.exp(-6 + 0.5 * torch.randn(
            (b, t, h, k), device=dev, generator=gen)))
    else:
        w = 0.5 + 0.5 * torch.rand((b, t, h, k), device=dev, generator=gen)
    u = 0.1 * torch.randn((h, k), device=dev, generator=gen)
    return [act(k), act(k), act(v), w.transpose(1, 2), u]


# (batch, T, heads, K, V): the serve phase's prefill and decode, then the
# reference sweep (tests/test_kernels.py), a ragged case, K and V off the
# kernel's lane split (K 40 pads to 64 over 8 lanes of 8 rows; V 24 and 56
# end inside a block's 64 columns; T 77 and 9 end inside a 16-token stage
# and a 4-token step) and a decode at V < 64 with the state in place
WKV_SHAPES = ((8, 512, 32, 64, 64), (8, 1, 32, 64, 64), (1, 16, 1, 8, 8),
              (1, 64, 2, 16, 16), (1, 100, 4, 32, 32), (1, 130, 2, 64, 64),
              (1, 200, 1, 8, 8), (2, 37, 3, 64, 8), (1, 77, 3, 40, 24),
              (2, 9, 2, 64, 56), (4, 1, 8, 64, 40))


def wkv_checks(dev, gen, shapes=WKV_SHAPES) -> dict:
    """``rwkv6_recurrence`` against its plain version at the serve phase's
    shapes (prefill [8, 512, 32, 64] and decode [8, 1, 32, 64] from a
    state, written in place) and the reference sweep's (K and V from 8 to
    64, T across chunk edges), in f32 and bf16, with and without s0 and
    ``kv_bf16``: kernel and plain version each within ``wkv_tolerance``
    of the float64 recurrence on the same inputs (so within twice it of
    each other)."""
    from repro_torch.kernels import rwkv6_recurrence as rk

    r = {"cases": 0, "max_abs_err": 0.0, "max_err_over_bound": 0.0,
         "plain_max_err_over_bound": 0.0}
    for b, t, h, k, v in shapes:
        if torch.device(dev).type == "cuda":
            check(rk.built_launch_shape(k, v) == rk.launch_shape(k, v),
                  f"rwkv6_recurrence K={k} V={v}: the build's launch shape "
                  f"{rk.built_launch_shape(k, v)} is not the wrapper's "
                  f"{rk.launch_shape(k, v)}")
        for dtype in (torch.float32, torch.bfloat16):
            for with_s0 in (False, True):
                for kv_bf16 in (False, True):
                    args = wkv_inputs(dev, gen, b, t, h, k, v, dtype,
                                      model_w=h == 32)
                    s0 = torch.randn((b, h, k, v), device=dev,
                                     generator=gen) if with_s0 else None
                    eo, es, otol, stol = rk.wkv_tolerance(
                        *args, s0, kv_bf16=kv_bf16)
                    po, ps = rk.plain(*args, s0, kv_bf16=kv_bf16)
                    o, s = rk.rwkv6_recurrence(*args, s0, kv_bf16=kv_bf16,
                                               s_out=s0)
                    torch.cuda.synchronize()
                    check(o.dtype == dtype and (o.stride() == args[2].stride()
                                                or o.device.type == "cpu"),
                          "rwkv6_recurrence: o not in v's dtype and layout")
                    check(s0 is None or s is s0,
                          "rwkv6_recurrence: the state was not written in "
                          "place")
                    for got_o, got_s, key in ((o, s, "max_err_over_bound"),
                                              (po, ps,
                                               "plain_max_err_over_bound")):
                        eo_ = (got_o.double() - eo).abs()
                        es_ = (got_s.double() - es).abs()
                        check(bool((eo_ <= otol).all()
                                   and (es_ <= stol).all()),
                              f"rwkv6_recurrence {(b, t, h, k, v)} {dtype} "
                              f"s0={with_s0} kv_bf16={kv_bf16} ({key}): off "
                              "the float64 recurrence beyond wkv_tolerance")
                        ratio = max((eo_ / otol.clamp_min(1e-300)).max()
                                    .item() if t else 0.0,
                                    (es_ / stol.clamp_min(1e-300)).max()
                                    .item())
                        r[key] = max(r[key], ratio)
                    r["max_abs_err"] = max(
                        r["max_abs_err"],
                        (o.float() - po.float()).abs().max().item()
                        if t else 0.0, (s - ps).abs().max().item())
                    r["cases"] += 1
    if torch.device(dev).type == "cuda":
        args = wkv_inputs(dev, gen, 1, 4, 1, 128, 64)
        for bad, err in (([args[0].float()] + args[1:], TypeError),
                         (args, ValueError)):
            try:
                rk.rwkv6_recurrence(*bad)
            except err:
                continue
            raise AssertionError("rwkv6_recurrence took operands it does "
                                 "not support")
    r["launch_shape"] = rk.launch_shape(64, 64)
    r["tolerance"] = ("wkv_tolerance: state E_t = |w_t| E_{t-1} + "
                      "3*2^-24*A_t (A the |.| recurrence), output "
                      "sum|r|E + (K+3)*2^-24*sum|r|(A + |u kv|) + its "
                      "rounding to v's dtype (2^-8 |o| for bf16)")
    return r


def wkv_work(b: int, t: int, h: int, k: int, v: int,
             in_bytes: int) -> tuple[int, int]:
    """``(bytes, flops)`` the recurrence needs: r, k, v read once in
    their dtype, w f32, u, s0 read and s written in f32, o written in v's
    dtype; 7 f32 operations per (k, v) per token (k·v, S + u·kv as two,
    r·(…) and its sum as two, w·S + kv as two)."""
    act = b * t * h
    nbytes = act * (2 * k + v) * in_bytes + act * k * 4 \
        + act * v * in_bytes + h * k * 4 + 2 * b * h * k * v * 4
    return nbytes, 7 * act * k * v


def wkv_timings(dev, gen, cfg, sizes) -> dict:
    """The serve phase's two WKV calls per layer: prefill ([batch,
    prompt, H, 64] bf16 in the model's layout, kv in bf16, from a zero
    state) and decode ([batch, 1, H, 64] from a state, in place).  CUDA
    events around back-to-back calls; at decode the host's launch rate
    bounds that window, so the device's own time per launch comes from
    the profiler too."""
    from repro_torch.kernels import rwkv6_recurrence as rk

    h, hd = cfg.d_model // 64, 64
    b, t = sizes.batch, sizes.prompt
    pre = wkv_inputs(dev, gen, b, t, h, hd, hd)
    s0 = torch.zeros((b, h, hd, hd), device=dev)
    dec = wkv_inputs(dev, gen, b, 1, h, hd, hd)
    sd = torch.randn((b, h, hd, hd), device=dev, generator=gen)
    nbytes, flops = wkv_work(b, t, h, hd, hd, 2)
    dbytes, dflops = wkv_work(b, 1, h, hd, hd, 2)

    def decode():
        rk.rwkv6_recurrence(*dec, sd, kv_bf16=True, s_out=sd)

    prof = device_profile(lambda: [decode() for _ in range(50)])
    per = [x for x in prof.get("top", []) if "wkv_kernel" in x["name"]]
    return {
        "ms": time_ms(lambda: rk.rwkv6_recurrence(*pre, s0, kv_bf16=True)),
        "plain_ms": time_ms(lambda: rk.plain(*pre, s0, kv_bf16=True),
                            reps=3, inner=1),
        "library_ms": None,       # no single PyTorch call computes it
        "bytes": nbytes, "flops": flops,
        "shape": [b, t, h, hd], "dtype": "bfloat16 (w float32)",
        "kv_bf16": True,
        "decode": {
            "shape": [b, 1, h, hd], "bytes": dbytes, "flops": dflops,
            "ms_back_to_back": time_ms(decode, inner=50),
            "plain_ms": time_ms(lambda: rk.plain(*dec, sd, kv_bf16=True)),
            "device_ms_per_launch": (per[0]["ms"] / per[0]["count"]
                                     if per else None)},
    }


# (batch, T, D): the hybrid serve phase's prefill and decode, its long
# prefill past the window, then the reference sweep (tests/test_kernels.py,
# no batch dims) and ragged lanes
RGLRU_SHAPES = ((8, 512, 4096), (8, 1, 4096), (2, 2560, 4096), (None, 8, 4),
                (None, 64, 16), (None, 300, 8), (None, 1024, 4),
                (3, 37, 1000))


def rglru_checks(dev, gen, shapes=RGLRU_SHAPES) -> dict:
    """``rglru_scan`` against its plain version at the hybrid serve
    phase's shapes (prefill [8, 512, 4096] and decode [8, 1, 4096] from a
    state written in place, the long prefill [2, 2560, 4096]) and the
    reference sweep's ([T, D] from zero), f32 and bf16 a and b, and a
    time-strided view: bit for bit equal to the plain version (both round
    the product and the sum separately), and both within
    ``rglru_tolerance`` of the float64 recurrence."""
    from repro_torch.kernels import chunk_scan as cs

    r = {"cases": 0, "max_abs_err": 0.0, "max_err_over_bound": 0.0,
         "plain_max_err_over_bound": 0.0}
    for b, t, d in shapes:
        lead = () if b is None else (b,)
        for dtype in (torch.float32, torch.bfloat16):
            for with_h0 in ((False,) if b is None else (False, True)):
                # decays as the model draws them near init: a in (0.9, 1)
                a = (0.9 + 0.1 * torch.rand(lead + (t, d), device=dev,
                                            generator=gen)).to(dtype)
                bb = torch.randn(lead + (t, d), device=dev,
                                 generator=gen).to(dtype)
                h0 = torch.randn(lead + (d,), device=dev, generator=gen) \
                    if with_h0 else None
                want = cs.rglru_plain(a, bb, h0)
                h_out = None if h0 is None else h0.clone()
                before = cs.rglru_launches
                got = cs.rglru_scan(a, bb, h_out, h_out=h_out)
                _sync(torch.device(dev))
                check(got.dtype == torch.float32 and got.shape == a.shape,
                      "rglru_scan: h not float32 of a's shape")
                check(h_out is None or torch.equal(h_out, got[..., -1, :]),
                      "rglru_scan: the final state was not written in place")
                check(torch.device(dev).type == "cpu"
                      or cs.rglru_launches == before + 1,
                      "rglru_scan did not launch its kernel")
                r["max_abs_err"] = max(r["max_abs_err"],
                                       _bitwise_err(got, want))
                exact, tol = cs.rglru_tolerance(a, bb, h0)
                for got_h, key in ((got, "max_err_over_bound"),
                                   (want, "plain_max_err_over_bound")):
                    ratio = ((got_h.double() - exact).abs()
                             / tol.clamp_min(1e-300)).max().item()
                    check(ratio <= 1, f"rglru_scan {(b, t, d)} {dtype} "
                          f"h0={with_h0} ({key}): {ratio:.3g} x "
                          "rglru_tolerance")
                    r[key] = max(r[key], ratio)
                r["cases"] += 1
    # a time-strided view (every other step of a longer buffer), read in
    # place
    a = 0.9 + 0.1 * torch.rand((2, 74, 256), device=dev, generator=gen)
    bb = torch.randn((2, 74, 256), device=dev, generator=gen)
    got = cs.rglru_scan(a[:, ::2], bb[:, ::2])
    r["max_abs_err"] = max(r["max_abs_err"], _bitwise_err(
        got, cs.rglru_plain(a[:, ::2], bb[:, ::2])))
    r["cases"] += 1
    if torch.device(dev).type == "cuda":
        for bad, err in (((a.double(), bb.double()), TypeError),
                         ((a, bb.bfloat16()), TypeError),
                         ((a.transpose(1, 2), bb.transpose(1, 2)),
                          ValueError)):
            try:
                cs.rglru_scan(*bad)
            except err:
                continue
            raise AssertionError("rglru_scan took operands it does not "
                                 "support")
    r["tolerance"] = ("bitwise to the plain version; both within "
                      "rglru_tolerance: E_t = |a_t| E_{t-1} (1+2u) + "
                      "u (1+u) (|a_t h_{t-1}| + |h_t|), u = 2^-24, around "
                      "the float64 recurrence")
    return r


def rglru_work(b: int, t: int, d: int, in_bytes: int = 4
               ) -> tuple[int, int]:
    """``(bytes, flops)`` the recurrence needs: a and b read once, h0
    read and h written in f32, the final state written (``h_out``); one
    multiply and one add per lane per step."""
    return (2 * b * t * d * in_bytes + b * t * d * 4 + 2 * b * d * 4,
            2 * b * t * d)


def rglru_timings(dev, gen, cfg, sizes) -> dict:
    """The hybrid serve phase's two calls per lru layer: prefill ([batch,
    prompt, lru_width] f32 a and b from the cached state, written back in
    place) and decode ([batch, 1, lru_width]); at decode the device time
    per launch comes from the profiler, as for the WKV."""
    from repro_torch.kernels import chunk_scan as cs

    b, t, d = sizes.batch, sizes.prompt, cfg.hybrid.lru_width or cfg.d_model

    def inputs(steps):
        return (0.9 + 0.1 * torch.rand((b, steps, d), device=dev,
                                       generator=gen),
                torch.randn((b, steps, d), device=dev, generator=gen),
                torch.randn((b, d), device=dev, generator=gen))
    pa, pb, ph = inputs(t)
    da, db, dh = inputs(1)
    nbytes, flops = rglru_work(b, t, d)
    dbytes, dflops = rglru_work(b, 1, d)

    def decode():
        cs.rglru_scan(da, db, dh, h_out=dh)

    prof = device_profile(lambda: [decode() for _ in range(50)])
    per = [x for x in prof.get("top", []) if "rglru_kernel" in x["name"]]
    return {
        "ms": time_ms(lambda: cs.rglru_scan(pa, pb, ph, h_out=ph)),
        "plain_ms": time_ms(lambda: cs.rglru_plain(pa, pb, ph), reps=5,
                            inner=1),
        "library_ms": None,       # no single PyTorch call computes it
        "bytes": nbytes, "flops": flops,
        "shape": [b, t, d], "dtype": "float32",
        "decode": {
            "shape": [b, 1, d], "bytes": dbytes, "flops": dflops,
            "ms_back_to_back": time_ms(decode, inner=50),
            "plain_ms": time_ms(lambda: cs.rglru_plain(da, db, dh)),
            "device_ms_per_launch": (per[0]["ms"] / per[0]["count"]
                                     if per else None)},
    }


def biggest_hop_rows(cfg, n: int) -> tuple[int, int]:
    """(ranks, blocks per rank) of the largest int8_hopquant hop: the
    largest leaf's 256-lane blocks, padded to a multiple of n, split in n
    ring chunks."""
    from repro_torch.configs.acis_100m import grad_leaf_specs

    lanes = max(math.prod(shape) for _, shape, _ in grad_leaf_specs(cfg))
    blocks = -(-lanes // 256)
    return n, -(-blocks // n)


def kernel_timings(dev, peak: float, f32_peak: float, cfg,
                   serve_cfg, hybrid_cfg) -> dict:
    """Each kernel at the main path's shapes: the largest ring hop (one
    fused bf16 add hop from the [8, 8, 3,072,000] chunked input into the
    [8, 3,072,000] partial sums, beside the shift + take + add step it
    replaced; the elementwise form, which the sim phase runs once a ring
    step, at the same [8, 3,072,000] add), the Coalesce bucket pack (f32 parts
    of 768, 9216 and 9216 per rank into the [8, 19200] arena), the largest
    int8_hopquant hop (the embed leaf's chunk, rank dims folded into
    rows; its ring-hop form from the [8, 8, blocks, 256] chunked input
    beside the shift + take + quant_combine step it replaces), the top-k
    accumulate of the embed leaf (k = 1% of its
    24,576,000 lanes into the [8, 24,576,000] f32 accumulator) and the
    local scan of fig5_scan ([8, 2^20] f32 along dim 1; fig5_scan_2d's
    [8, 16384, 64] beside it), the serve phase's WKV
    (:func:`wkv_timings`) and the hybrid serve phase's RG-LRU scan
    (:func:`rglru_timings`).  ``bound_ms`` is the larger of the bytes over
    the memory rate and the f32 operations (where counted) over the f32
    rate; ``bound_by`` says which."""
    from repro_torch.configs.acis_100m import grad_leaf_specs
    from repro_torch.kernels import chunk_scan as cs
    from repro_torch.kernels import fused_combine as fc
    from repro_torch.kernels import pack_combine as pc
    from repro_torch.kernels import quant_combine as qc
    from repro_torch.kernels import topk_accum as ta

    from repro_torch.kernels import ref
    from repro_torch.mesh import LocalMesh

    gen = torch.Generator(device=dev).manual_seed(99)
    x = torch.randn((8, 3_072_000), device=dev, generator=gen).bfloat16()
    y = torch.randn((8, 3_072_000), device=dev, generator=gen).bfloat16()
    out = torch.empty_like(x)
    comb = {
        "ms": time_ms(lambda: fc.fused_combine(x, y, op="add")),
        "plain_ms": time_ms(lambda: fc.plain(x, y, "add")),
        "library_ms": time_ms(lambda: torch.add(x, y, out=out)),
        "device_ms_per_launch": per_launch(
            lambda: fc.fused_combine(x, y, op="add"), "combine_kernel"),
        "bytes": 3 * x.numel() * x.element_size(),
        "shape": [8, 3_072_000], "dtype": "bfloat16", "op": "add",
    }
    del x, y, out
    # one hop of the largest acis-100m ring: xs is every rank's input in 8
    # chunks, buf the partial sums; its plain version is the step the ring
    # takes without the kernel, the transport's shift and per-rank take,
    # then the add (no single PyTorch call does the hop)
    mesh = LocalMesh({"data": 8}, device=dev)
    i = mesh.axis_index("data")
    xs = torch.randn((8, 8, 3_072_000), device=dev,
                     generator=gen).bfloat16()
    buf = xs[:, 1].clone()
    hop = {
        "ms": time_ms(lambda: fc.fused_hop(buf, xs, 0, dim=0, rank_ndim=1)),
        "plain_ms": time_ms(lambda: ref.combine_add(
            mesh.shift(buf, "data", 1), mesh.take(xs, (i - 2) % 8))),
        "library_ms": None,
        "device_ms_per_launch": per_launch(
            lambda: fc.fused_hop(buf, xs, 0, dim=0, rank_ndim=1),
            "hop_kernel"),
        "bytes": 3 * buf.numel() * buf.element_size(),
        "unfused_bytes": 7 * buf.numel() * buf.element_size(),
        "shape": [8, 8, 3_072_000], "dtype": "bfloat16", "op": "add",
    }
    del xs, buf
    arena = torch.zeros((8, 19200), device=dev)
    parts = [torch.randn((8, s), device=dev, generator=gen)
             for s in (768, 9216, 9216)]
    pack = {
        "ms": time_ms(lambda: pc.fused_pack(arena, *parts)),
        "plain_ms": time_ms(lambda: pc.plain(arena, *parts)),
        "library_ms": time_ms(lambda: torch.cat(parts, dim=-1, out=arena)),
        "device_ms_per_launch": per_launch(
            lambda: pc.fused_pack(arena, *parts), "pack_kernel"),
        "library_device_ms_per_launch": per_launch(
            lambda: torch.cat(parts, dim=-1, out=arena),
            "CatArrayBatchedCopy"),
        "host_us_per_call": host_us(lambda: pc.fused_pack(arena, *parts)),
        "library_host_us_per_call": host_us(
            lambda: torch.cat(parts, dim=-1, out=arena)),
        "bytes": 2 * sum(p.numel() for p in parts) * 4,
        "shape": [8, 19200], "dtype": "float32", "op": None,
    }
    ranks, blocks = biggest_hop_rows(cfg, 8)
    qa = torch.randint(-127, 128, (ranks, blocks, 256), device=dev,
                       generator=gen, dtype=torch.int8)
    qb = torch.randint(-127, 128, (ranks, blocks, 256), device=dev,
                       generator=gen, dtype=torch.int8)
    sa = torch.rand((ranks, blocks), device=dev, generator=gen)
    sb = torch.rand((ranks, blocks), device=dev, generator=gen)
    quant = {
        "ms": time_ms(lambda: qc.quant_combine(qa, sa, qb, sb)),
        "plain_ms": time_ms(lambda: qc.plain(qa, sa, qb, sb)),
        "library_ms": None,       # no single PyTorch call computes it
        "device_ms_per_launch": per_launch(
            lambda: qc.quant_combine(qa, sa, qb, sb),
            "quant_combine_kernel"),
        "bytes": ranks * blocks * 3 * (256 + 4),
        "shape": [ranks, blocks, 256], "dtype": "int8+float32",
    }
    del qa, qb, sa, sb
    # the same hop as the ring takes it: xs is every rank's payload and
    # scales in 8 chunks, buf the partial sums; beside it the unfused step
    # (the transport's shift and per-rank take of payload and scales, then
    # the elementwise kernel) and the hop's plain version
    qx = torch.randint(-127, 128, (ranks, 8, blocks, 256), device=dev,
                       generator=gen, dtype=torch.int8)
    sx = torch.rand((ranks, 8, blocks), device=dev, generator=gen)
    qbuf, sbuf = qx[:, 1].clone(), sx[:, 1].clone()

    def fused():
        return qc.quant_hop(qbuf, sbuf, qx, sx, 0, dim=0, rank_ndim=1)

    def unfused():
        c = (i - 2) % 8
        return qc.quant_combine(mesh.shift(qbuf, "data", 1),
                                mesh.shift(sbuf, "data", 1),
                                mesh.take(qx, c), mesh.take(sx, c))
    qhop = {
        "ms": time_ms(fused),
        "plain_ms": time_ms(lambda: qc.hop_plain(qbuf, sbuf, qx, sx, 0,
                                                 dim=0, rank_ndim=1)),
        "unfused_ms": time_ms(unfused),
        "library_ms": None,       # no single PyTorch call computes it
        "device_ms_per_launch": per_launch(fused, "quant_hop_kernel"),
        "bytes": ranks * blocks * 3 * (256 + 4),
        "unfused_bytes": ranks * blocks * 7 * (256 + 4),
        "shape": [ranks, 8, blocks, 256], "dtype": "int8+float32",
    }
    del qx, sx, qbuf, sbuf
    size = max(math.prod(shape) for _, shape, _ in grad_leaf_specs(cfg))
    k = int(size * 0.01)
    dense = torch.zeros((8, size), device=dev)
    idx = torch.stack([torch.randperm(size, device=dev, generator=gen)[:k]
                       for _ in range(8)]).to(torch.int32)
    vals = torch.randn((8, k), device=dev, generator=gen)
    flat_idx = (idx.long() + torch.arange(8, device=dev)[:, None] * size
                ).view(-1)
    flat_vals = vals.view(-1)
    # the card moves 32-byte sectors: each distinct sector the payload
    # touches is read and written back (64 bytes), beside the payload
    sectors = sum(torch.unique(row.long() // 8).numel() for row in idx)
    topk = {
        "ms": time_ms(lambda: ta.topk_accumulate_(dense, idx, vals)),
        "plain_ms": time_ms(lambda: ta.plain(dense, idx, vals)),
        "library_ms": time_ms(lambda: dense.view(-1).index_add_(
            0, flat_idx, flat_vals)),
        "bytes": idx.numel() * (4 + 4) + idx.numel() * 4 * 2,
        "sectors": sectors,
        "sector_bound_ms": (idx.numel() * (4 + 4) + 64 * sectors) / peak
        * 1e3,
        "shape": [8, size], "k": k, "dtype": "float32",
    }
    del dense, idx, vals, flat_idx, flat_vals
    x = torch.randn((8, 1 << 20), device=dev, generator=gen)
    x2 = torch.randn((8, 16384, 64), device=dev, generator=gen)
    scan = {
        "ms": time_ms(lambda: cs.prefix_sum(x, 1)),
        "plain_ms": time_ms(lambda: cs.plain(x, 1)),
        "library_ms": time_ms(lambda: torch.cumsum(x, dim=1)),
        "device_ms_per_launch": per_launch(lambda: cs.prefix_sum(x, 1),
                                           "scan_kernel"),
        "bytes": 2 * x.numel() * x.element_size(),
        "shape": [8, 1 << 20], "dim": 1, "dtype": "float32",
        "ms_2d": time_ms(lambda: cs.prefix_sum(x2, 1)),
        "library_ms_2d": time_ms(lambda: torch.cumsum(x2, dim=1)),
        "device_ms_per_launch_2d": per_launch(
            lambda: cs.prefix_sum(x2, 1), "scan_kernel"),
        "shape_2d": [8, 16384, 64],
    }
    del x, x2
    torch.cuda.empty_cache()
    out = {"fused_combine": comb, "fused_hop": hop, "fused_pack": pack,
           "quant_combine": quant, "quant_hop": qhop,
           "topk_accumulate": topk, "prefix_sum": scan,
           "rwkv6_recurrence": wkv_timings(dev, gen, serve_cfg, SERVE),
           "rglru_scan": rglru_timings(dev, gen, hybrid_cfg, SERVE_HYBRID)}
    for t in out.values():
        by_bytes = t["bytes"] / peak * 1e3
        by_ops = t.get("flops", 0) / f32_peak * 1e3
        t["bound_ms"] = max(by_bytes, by_ops)
        t["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
    return out


def host_us(call, calls: int = 2000) -> float:
    """Host wall time per call over ``calls`` back-to-back calls between
    two device syncs: the host path's cost where it exceeds the device
    time, as for a pack of a bucket's size."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def per_launch(call, name: str, calls: int = 50):
    """Device time per launch of the kernel whose name holds ``name``,
    from the profiler over ``calls`` calls (None if it saw none)."""
    prof = device_profile(lambda: [call() for _ in range(calls)])
    per = [x for x in prof.get("top", []) if name in x["name"]]
    return per[0]["ms"] / per[0]["count"] if per else None


# ---------------------------------------------------------------------------
# phases 4-5: the main paths
# ---------------------------------------------------------------------------

def pack_parts(st) -> int:
    """Non-empty parts the arena pack of stage ``st`` writes."""
    return sum(1 for k in st.ir.nodes[0].op.fn.bucket_sizes if k)


def expected_launches(compiled, mesh) -> dict:
    """Each kernel's launches in one sync, read off the compiled plan:
    n-1 fused hops per bandwidth ring all-reduce or reduce-scatter stage
    over an axis of n ranks (n-1 elementwise hop combines on a latency
    ring, n-1 quant hops on an int8-coded one), one pack launch per
    ``MAX_PARTS`` parts of an arena pack, n-1 quant hops per
    int8_hopquant EF stage, and per top-k EF stage one accumulate of the
    rank's own payload, n-1 of the hops' and one for the decompress, and
    one prefix_sum (every rank's local scan at once) per inclusive-add
    scan+allgather stage."""
    from repro_torch.kernels import pack_combine as pc

    out = dict.fromkeys(kernel_modules(), 0)
    for st in compiled.stages:
        n = mesh.axis_size(st.axis) if st.axis else 1
        if st.kind == "scan+allgather":
            scan = st.ir.nodes[1].op
            if scan.monoid.name == "add" and not scan.exclusive:
                out["prefix_sum"] += 1
        if st.kind in ("allreduce", "batched_allreduce"):
            codec = st.ir.nodes[-1].op.codec
            if codec.combine_encoded is not None:
                out["quant_hop"] += n - 1         # the int8 wire's ring
            else:
                hop = "fused_hop" if st.schedule == "bandwidth" \
                    else "fused_combine"
                out[hop] += n - 1
        if st.kind == "reduce_scatter":
            out["fused_hop"] += n - 1
        if st.arena_slot is not None:
            out["fused_pack"] += -(-pack_parts(st) // pc.MAX_PARTS)
        if st.kind in ("ef_allreduce", "delivered"):
            comp = st.ir.nodes[0].op.ef.compressor
            if comp == "int8_hopquant":
                out["quant_hop"] += n - 1
            elif comp == "topk":
                out["topk_accumulate"] += n + 1
    return out


def check_launches(launches: dict, per_sync: dict, syncs: int) -> None:
    for k, n in per_sync.items():
        check(launches[k] == syncs * n,
              f"{k} launched {launches[k]} times, the plan needs "
              f"{syncs} x {n}")


def in_turns(step: int, run_k, run_p) -> tuple:
    """``(run_k(), run_p())``, the plain sync first on odd steps, so that
    running first or second is not what separates their times."""
    if step % 2:
        res_p = run_p()
        return run_k(), res_p
    res_k = run_k()
    return res_k, run_p()


def main_path(mesh, cfg, seed: int, *, steps: int = 3,
              expect_kernels: bool = True, backend: str = "acis") -> dict:
    """The acis path: warm-up, then kernel and plain syncs in turns.

    On a two-axis mesh (``backend="acis_hierarchical"``, the
    hierarchical phase) it also holds overlapped dispatch (a stream per
    mesh axis) bitwise to serial dispatch, and the hierarchical mean to
    the flat ``acis`` sync of the same gradients on ``LocalMesh({"data":
    8})`` within twice the ring's rounding bound (each is within it of
    the exact mean; the fold orders differ)."""
    from repro_torch import core as acis
    from repro_torch.configs.acis_100m import grad_leaf_specs

    dev = mesh.device
    cuda = dev.type == "cuda"
    sync_dev = torch.cuda.synchronize if cuda else (lambda: None)
    gen = torch.Generator(device=dev).manual_seed(seed)
    specs = grad_leaf_specs(cfg)
    grads = {k: torch.randn(mesh.rank_shape + shape, device=dev,
                            generator=gen).to(dt) for k, shape, dt in specs}
    n_params = sum(math.prod(shape) for _, shape, _ in specs)
    local_bytes = sum(math.prod(shape) * v.element_size()
                      for (_, shape, _), v in zip(specs, grads.values()))
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def sync_once(eng, arenas):
        ptrs = [a.data_ptr() for a in arenas]
        sync_dev()
        t0 = time.perf_counter()
        out, _, back = eng.gradient_sync(grads, None, arenas=arenas,
                                         mesh=mesh)
        sync_dev()
        dt = (time.perf_counter() - t0) * 1e3
        check(back == tuple(arenas), "sync returned other arenas")
        check([a.data_ptr() for a in arenas] == ptrs,
              "arena data_ptr changed across a sync")
        return out, dt

    outer = "pod" if "pod" in mesh.axis_names else None
    eng_k = acis.make_engine(backend, outer_axis=outer)
    check(eng_k.config.use_kernels, "use_kernels is off by default")
    t0 = time.perf_counter()
    arenas_k = eng_k.init_arenas(grads, mesh=mesh)
    compile_ms = (time.perf_counter() - t0) * 1e3
    check(arenas_k is not None, "the sync program has no bucket arena")
    compiled = eng_k.last_sync_program()
    per_sync = expected_launches(compiled, mesh)
    eng_p = acis.make_engine(backend, outer_axis=outer, use_kernels=False)
    arenas_p = eng_p.init_arenas(grads, mesh=mesh)

    # the counts cover exactly the main path's syncs: one untimed round
    # (a warm-up per engine, with the timed rounds' buffer lifetimes, so
    # the caching allocator has grown before the clock runs), then kernel
    # and plain syncs in turns, alternating which goes first
    reset_counts()
    t_k, t_p = [], []
    for step in range(-1, steps):
        out_k = out_p = None
        (out_k, dt_k), (out_p, dt_p) = in_turns(
            step, lambda: sync_once(eng_k, arenas_k),
            lambda: sync_once(eng_p, arenas_p))
        for k in grads:
            check(torch.equal(out_k[k], out_p[k]),
                  f"{k}: kernel sync differs from use_kernels=False")
        if step >= 0:
            t_k.append(dt_k)
            t_p.append(dt_p)
    launches = read_counts()
    if expect_kernels:
        check_launches(launches, per_sync, steps + 1)
        check(per_sync["fused_hop"] > 0 and per_sync["fused_pack"] > 0,
              "the acis plan runs no fused hop or pack")

    # The xla baseline and the f32 mean round each lane once; the ring
    # rounds its bf16 partial sum at each of its n-1 hops (over both axes
    # on two, 3 + 1 for pod 2 x data 4), by at most half an ulp (2^-8
    # relative) of that partial sum, which is bounded by the lane's sum
    # of |g|.  After the mean a lane may differ by (n-1)/2 * 2^-7 * sum|g|
    # / n, plus one ulp of the result.
    out_x, _ = acis.make_engine("xla", outer_axis=outer).gradient_sync(
        grads, None, mesh=mesh)
    n = mesh.n_ranks
    nd = mesh.rank_ndim
    bounds = {}
    worst_x = worst_mean = 0.0
    for k in grads:
        o = out_k[k]
        check(tuple(o.shape) == tuple(grads[k].shape) and
              o.dtype == grads[k].dtype, f"{k}: wrong shape/dtype")
        check(bool(torch.isfinite(o).all()), f"{k}: non-finite output")
        g = grads[k].flatten(0, nd - 1)
        mean = g.float().mean(0)
        eps = 2.0 ** -7 if o.dtype == torch.bfloat16 else 2.0 ** -23
        bound = bounds[k] = (n - 1) / 2 * eps * g.abs().float().sum(0) / n \
            + eps * mean.abs()
        dx = (o.float() - out_x[k].float()).abs()
        dm = (o.flatten(0, nd - 1)[0].float() - mean).abs()
        check(bool((dx <= bound + eps * out_x[k].float().abs()).all()),
              f"{k}: {backend} and xla differ beyond the ring's rounding")
        check(bool((dm <= bound).all()),
              f"{k}: {backend} and the exact mean differ beyond the ring's "
              "rounding")
        worst_x = max(worst_x, dx.max().item())
        worst_mean = max(worst_mean, dm.max().item())
    extra = {}
    if outer is not None:
        extra = hierarchical_checks(mesh, grads, out_k, eng_k, arenas_k,
                                    compiled, bounds, sync_once, steps)

    profile = {name: device_profile(lambda e=e, a=a: e.gradient_sync(
        grads, None, arenas=a, mesh=mesh), RING_OPS)
        for name, e, a in (("kernels", eng_k, arenas_k),
                           ("plain", eng_p, arenas_p))} if cuda else None
    med_k, med_p = statistics.median(t_k), statistics.median(t_p)
    return {
        "phase": "acis" if outer is None else "hierarchical",
        "backend": backend, "mesh": dict(mesh.axes),
        "model": cfg.name, "ranks": n,
        "leaves": len(specs), "params_per_rank": n_params,
        "bytes_per_rank": local_bytes, "steps": steps,
        "stages": len(compiled.stages),
        "stage_kinds": compiled.stage_kinds(),
        "waves": compiled.plan.n_waves,
        "arena_shapes": [list(a.shape) for a in arenas_k],
        "max_pack_parts": max(pack_parts(st) for st in compiled.stages
                              if st.arena_slot is not None),
        "pack_transient_bytes": compiled.pack_transient_bytes(),
        "launches_per_sync": per_sync, "launches": launches,
        "sync_ms_kernels": t_k, "sync_ms_plain": t_p,
        "median_sync_ms_kernels": med_k, "median_sync_ms_plain": med_p,
        "ring_algbw_GBps_kernels":
            local_bytes * 2 * (n - 1) / n / (med_k * 1e-3) / 1e9,
        "max_abs_diff_vs_xla": worst_x,
        "max_abs_diff_vs_f32_mean": worst_mean,
        "bitwise_equal_to_plain": True,
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if cuda else None),
        "compile_ms": compile_ms,
        "cost_model_program_time_s": compiled.program_time(),
        "cost_model": COST_MODEL_NOTE,
        **extra,
        "profile": profile,
    }


COST_MODEL_NOTE = ("netmodel.program_time of the compiled plan: the cost "
                   "model's time for the paper's Table II switch "
                   "(PAPER_CGRA placements), not a time on this card")


def hierarchical_checks(mesh, grads, out_k, eng_k, arenas_k, compiled,
                        bounds, sync_once, steps: int) -> dict:
    """The hierarchical phase's own checks, after the timed syncs (their
    launches are not counted): the multi-axis waves ran on one stream per
    mesh axis; serial-dispatch syncs (``overlap_dispatch=False``, kernels
    on) bitwise equal to the overlapped ones, ``steps`` of each timed in
    turns after a warm-up, and one of each profiled; the flat ``acis``
    sync of the same gradients on ``LocalMesh({"data": n_ranks})`` within
    twice the ring bound of the hierarchical mean."""
    from repro_torch import core as acis
    from repro_torch.mesh import LocalMesh

    cuda = mesh.device.type == "cuda"
    multi = sum(1 for groups in compiled.plan.dispatch_groups()
                if sum(1 for ax, _ in groups if ax) > 1)
    streams = sorted(ax for _, ax in compiled.plan.streams)
    if cuda:
        check(multi == 0 or streams == sorted(mesh.axis_names),
              f"{multi} multi-axis waves ran on streams {streams}")
    eng_s = acis.make_engine(eng_k.config.backend, outer_axis="pod",
                             overlap_dispatch=False)
    arenas_s = eng_s.init_arenas(grads, mesh=mesh)
    sync_once(eng_s, arenas_s)                          # warm-up
    t_o, t_s = [], []
    for step in range(steps):
        (out_o, dt_o), (out_s, dt_s) = in_turns(
            step, lambda: sync_once(eng_k, arenas_k),
            lambda: sync_once(eng_s, arenas_s))
        for k in grads:
            check(torch.equal(out_s[k], out_k[k])
                  and torch.equal(out_o[k], out_k[k]),
                  f"{k}: serial dispatch differs from overlapped")
        t_o.append(dt_o)
        t_s.append(dt_s)
    profile = {name: device_profile(lambda e=e, a=a: e.gradient_sync(
        grads, None, arenas=a, mesh=mesh), RING_OPS)
        for name, e, a in (("overlapped", eng_k, arenas_k),
                           ("serial", eng_s, arenas_s))} if cuda else None
    flat = LocalMesh({"data": mesh.n_ranks}, device=mesh.device)
    nd = mesh.rank_ndim
    g_flat = {k: v.flatten(0, nd - 1) for k, v in grads.items()}
    out_f, _ = acis.make_engine("acis").gradient_sync(g_flat, None,
                                                      mesh=flat)
    worst = 0.0
    for k in grads:
        d = (out_k[k].flatten(0, nd - 1).float() - out_f[k].float()).abs()
        check(bool((d <= 2 * bounds[k]).all()),
              f"{k}: hierarchical and flat acis differ beyond twice the "
              "ring's rounding")
        worst = max(worst, d.max().item())
    return {"multi_axis_waves": multi, "streams": streams,
            "overlapped_ms": t_o, "serial_ms": t_s,
            "median_overlapped_ms": statistics.median(t_o),
            "median_serial_ms": statistics.median(t_s),
            "dispatch_profile": profile,
            "serial_bitwise_equal_to_overlapped": True,
            "max_abs_diff_vs_flat_acis": worst,
            "flat_bound": "2 x ((n-1)/2 * eps * sum|g| / n + eps * |mean|)"}


def compressed_path(mesh, cfg, seed: int, compressor: str, *,
                    steps: int = 3, expect_kernels: bool = True,
                    backend: str = "acis_compressed") -> dict:
    """The acis_compressed path for one compressor: warm-up, then 3 steps
    with the EF residual threaded, kernel and plain syncs in turns.

    The EF identity over the steps — the cumulative exact mean minus the
    cumulative synced mean equals the mean over ranks of the final
    residual — holds up to the rounding the path does, summed over the
    steps, per leaf: the target ``g + r`` rounds to the gradient's dtype
    (``eps·(max|g| + 2·max|r|)``, ``eps`` = 2^-8 for bf16, 2^-23 for
    f32), the mean rounds the total twice (``2·eps·max|out|``), the f32
    sums round (``2^-23·M``, ``M`` the largest sum over the ranks of
    ``|g| + |r|``), and ``int8_hopquant``'s hops requantize within half
    a step each, which no residual sees (``(n-1)/2·M/127/n``)."""
    from repro_torch import core as acis
    from repro_torch.configs.acis_100m import grad_leaf_specs

    dev = mesh.device
    cuda = dev.type == "cuda"
    sync_dev = torch.cuda.synchronize if cuda else (lambda: None)
    specs = grad_leaf_specs(cfg)
    n, d_ring = mesh.n_ranks, mesh.axis_size("data")
    nd = mesh.rank_ndim
    outer = "pod" if "pod" in mesh.axis_names else None

    def grads_at(step):
        gen = torch.Generator(device=dev).manual_seed(seed * 1000 + step + 1)
        return {k: torch.randn(mesh.rank_shape + shape, device=dev,
                               generator=gen).to(dt)
                for k, shape, dt in specs}

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    eng_k = acis.make_engine(backend, compressor=compressor,
                             outer_axis=outer)
    check(eng_k.config.use_kernels, "use_kernels is off by default")
    eng_p = acis.make_engine(backend, compressor=compressor,
                             outer_axis=outer, use_kernels=False)
    g = grads_at(0)
    t0 = time.perf_counter()
    ar_k = eng_k.init_arenas(g, mesh=mesh)
    compile_ms = (time.perf_counter() - t0) * 1e3
    ar_p = eng_p.init_arenas(g, mesh=mesh)
    compiled = eng_k.last_sync_program()
    per_sync = expected_launches(compiled, mesh)

    def sync_once(eng, grads, state, arenas):
        sync_dev()
        t0 = time.perf_counter()
        if arenas is not None:
            out, new, back = eng.gradient_sync(grads, state, arenas=arenas,
                                               mesh=mesh)
            check(back == tuple(arenas), "sync returned other arenas")
        else:
            out, new = eng.gradient_sync(grads, state, mesh=mesh)
        sync_dev()
        return out, new, (time.perf_counter() - t0) * 1e3

    # the counts cover exactly this path's syncs: one untimed round (a
    # warm-up per engine with the timed steps' buffer lifetimes, its
    # results dropped), then the 3 steps from a zero residual
    reset_counts()
    st_k, st_p = eng_k.init_state(g), eng_p.init_state(g)
    for k, v in g.items():
        check(st_k[k].shape == v.shape and st_k[k].dtype == torch.float32
              and not st_k[k].any(), f"{k}: init_state is not f32 zeros")
    res_bytes = sum(v.numel() * v.element_size() for v in st_k.values())
    cum_true = {k: torch.zeros(v.shape[nd:], device=dev)
                for k, v in g.items()}
    cum_got = {k: torch.zeros(v.shape[nd:], device=dev)
               for k, v in g.items()}
    tol = dict.fromkeys(g, 0.0)
    t_k, t_p = [], []
    worst_rank = 0.0
    warm_k = sync_once(eng_k, g, st_k, ar_k)
    warm_p = sync_once(eng_p, g, st_p, ar_p)
    del warm_k, warm_p
    for step in range(steps):
        if step:
            g = grads_at(step)
        terms = {}
        for k in g:
            eps = 2.0 ** -8 if g[k].dtype == torch.bfloat16 else 2.0 ** -23
            m = (g[k].float().abs() + st_k[k].abs()).flatten(0, nd - 1) \
                .sum(0).max().item()
            terms[k] = (eps, m, eps * (g[k].abs().max().item()
                                       + 2 * st_k[k].abs().max().item())
                        + 2.0 ** -23 * m)
        (out_k, new_k, dt_k), (out_p, new_p, dt_p) = in_turns(
            step, lambda: sync_once(eng_k, g, st_k, ar_k),
            lambda: sync_once(eng_p, g, st_p, ar_p))
        t_k.append(dt_k)
        t_p.append(dt_p)
        for k in g:
            o = out_k[k]
            check(torch.equal(o, out_p[k]) and torch.equal(new_k[k],
                                                           new_p[k]),
                  f"{compressor} {k}: kernel sync differs from "
                  "use_kernels=False")
            check(tuple(o.shape) == tuple(g[k].shape)
                  and o.dtype == g[k].dtype
                  and new_k[k].dtype == torch.float32,
                  f"{compressor} {k}: wrong shape/dtype")
            check(bool(torch.isfinite(o).all()
                       and torch.isfinite(new_k[k]).all()),
                  f"{compressor} {k}: non-finite output or residual")
            eps, m, term = terms[k]
            omax = o.abs().max().item()
            # every rank holds the same totals: the RS∘AG rings bit for
            # bit; the sparse ring adds in a rank-relative order, so its
            # ranks agree within one rounding of the output and of the sum
            of = o.flatten(0, nd - 1)
            dr = (of.float() - of[0:1].float()).abs().max().item()
            worst_rank = max(worst_rank, dr)
            if compressor == "topk":
                check(dr <= eps * omax + 2.0 ** -23 * m,
                      f"topk {k}: ranks differ by {dr}")
            else:
                check(dr == 0.0, f"{compressor} {k}: ranks differ by {dr}")
            term += 2 * eps * omax
            if compressor == "int8_hopquant":
                term += n / d_ring * (d_ring - 1) / 2 * m / 127 / n
            tol[k] += term
            cum_true[k] += g[k].float().flatten(0, nd - 1).mean(0)
            cum_got[k] += of[0].float()
        st_k, st_p = new_k, new_p
        del out_k, out_p, new_k, new_p
    launches = read_counts()
    if expect_kernels:
        check_launches(launches, per_sync, steps + 1)
        kernel = {"int8_hopquant": "quant_hop",
                  "topk": "topk_accumulate"}.get(compressor)
        check(kernel is None or per_sync[kernel] > 0,
              f"the {compressor} plan runs no {kernel}")

    worst_ratio = worst_err = 0.0
    for k in g:
        err = ((cum_true[k] - cum_got[k])
               - st_k[k].flatten(0, nd - 1).mean(0)).abs().max()
        slack = 2.0 ** -22 * (cum_true[k].abs().max()
                              + cum_got[k].abs().max()).item()
        ratio = err.item() / (tol[k] + slack)
        check(ratio <= 1.0, f"{compressor} {k}: the EF identity misses by "
              f"{err.item()}, beyond its rounding bound {tol[k] + slack}")
        worst_ratio = max(worst_ratio, ratio)
        worst_err = max(worst_err, err.item())

    profile = {name: device_profile(lambda e=e, s=s, a=a: sync_once(
        e, g, s, a), RING_OPS) for name, e, s, a in (
            ("kernels", eng_k, st_k, ar_k), ("plain", eng_p, st_p, ar_p))} \
        if cuda else None
    med_k, med_p = statistics.median(t_k), statistics.median(t_p)
    return {
        "phase": "compressed" if outer is None else "hierarchical",
        "backend": backend, "mesh": dict(mesh.axes),
        "compressor": compressor, "model": cfg.name,
        "ranks": n, "leaves": len(specs),
        "params_per_rank": sum(v.flatten(0, nd - 1)[0].numel()
                               for v in g.values()),
        "residual_bytes": res_bytes, "steps": steps,
        "stages": len(compiled.stages),
        "stage_kinds": compiled.stage_kinds(),
        "waves": compiled.plan.n_waves,
        "arena_shapes": [list(a.shape) for a in ar_k or ()],
        "launches_per_sync": per_sync, "launches": launches,
        "sync_ms_kernels": t_k, "sync_ms_plain": t_p,
        "median_sync_ms_kernels": med_k, "median_sync_ms_plain": med_p,
        "bitwise_equal_to_plain": True,
        "max_rank_diff": worst_rank,
        "ef_identity_max_abs_err": worst_err,
        "ef_identity_err_over_bound": worst_ratio,
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if cuda else None),
        "compile_ms": compile_ms,
        "cost_model_program_time_s": compiled.program_time(),
        "cost_model": COST_MODEL_NOTE,
        "profile": profile,
    }


# F2's program on the card: f32 per rank (16 MiB; its reduce-scatter
# chunks are whole 256-lane int8 blocks)
F2_LOCAL = 1 << 22


def f2_path(mesh, seed: int, local: int, *, steps: int = 3,
            expect_kernels: bool = True) -> dict:
    """F2's program: ``engine.compile`` of ``reduce(v, axis="auto")`` on
    ``acis_hierarchical_compressed`` over pod x data, the config's int8
    codec on the pod all-reduce.  One untimed call, then ``steps`` calls
    in turns with ``use_kernels=False``, bitwise equal, every rank the
    same total; the reduce-scatter hops launched ``fused_hop`` and the
    pod hop ``quant_hop`` as the plan says.  Held to the exact sum: the
    data ring's f32 adds, each pod's encode and the pod combine's requant
    move a lane by at most half a scale step each, a step being a block's
    largest |partial sum| / 127, so by at most ``1.01·T/127 +
    2^-20·S`` with ``T`` the sum over the pods of the lane's 256-lane
    block's largest per-pod sum of |x|, and ``S`` the lane's sum of |x|."""
    from repro_torch import core as acis
    from repro_torch.mesh import P

    dev = mesh.device
    cuda = dev.type == "cuda"
    n, pods = mesh.n_ranks, mesh.axis_size("pod")
    gen = torch.Generator(device=dev).manual_seed(seed + 29)
    x = torch.randn((n * local,), device=dev, generator=gen)
    spec = P(("pod", "data"))
    avals = (acis.TensorSpec((local,), torch.float32),)

    def prog(v):
        return acis.reduce(v, axis="auto")

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    eng_k = acis.make_engine("acis_hierarchical_compressed",
                             outer_axis="pod")
    eng_p = acis.make_engine("acis_hierarchical_compressed",
                             outer_axis="pod", use_kernels=False)
    t0 = time.perf_counter()
    fk = eng_k.compile(prog, mesh, spec, spec, in_avals=avals)
    compile_ms = (time.perf_counter() - t0) * 1e3
    fp = eng_p.compile(prog, mesh, spec, spec, in_avals=avals)
    codecs = [[nd.op.codec.name for nd in st.ir.nodes]
              for st in fk.compiled.stages]
    check(fk.stages == fp.stages == ["map", "reduce_scatter", "allreduce",
                                     "allgather", "map"]
          and fk.axes[2] == "pod" and codecs[2] == ["int8_b256"],
          f"F2 program compiled to {fk.stages} {fk.axes} {codecs}")
    per_call = expected_launches(fk.compiled, mesh)
    sync_dev = torch.cuda.synchronize if cuda else (lambda: None)

    def timed(fn):
        sync_dev()
        t = time.perf_counter()
        out = fn(x)
        sync_dev()
        return out, (time.perf_counter() - t) * 1e3

    reset_counts()
    t_k, t_p = [], []
    for step in range(-1, steps):
        (ok, dk), (op, dp) = in_turns(step, lambda: timed(fk),
                                      lambda: timed(fp))
        _bitwise_err(ok, op)
        if step >= 0:
            t_k.append(dk)
            t_p.append(dp)
    launches = read_counts()
    if expect_kernels:
        check_launches(launches, per_call, steps + 1)
        check(per_call["quant_hop"] > 0 and per_call["fused_hop"] > 0,
              "F2's plan runs no quant_hop or fused_hop")
    ranks = ok.view(n, local)
    check(bool((ranks == ranks[0:1]).all()), "F2: ranks hold other totals")
    a = x.view(pods, n // pods, local).double().abs()
    blk = a.sum(1).view(pods, -1, 256).amax(-1).sum(0)       # T per block
    bound = 1.01 * blk.repeat_interleave(256) / 127 \
        + 2.0 ** -20 * a.sum((0, 1))
    err = (ranks[0].double() - x.view(n, local).double().sum(0)).abs()
    check(bool((err <= bound).all()),
          f"F2: {err.max().item()} off the exact sum, beyond the int8 "
          "bound")
    return {
        "phase": "hierarchical", "program": "f2_compressed_reduce",
        "backend": "acis_hierarchical_compressed", "mesh": dict(mesh.axes),
        "local": local, "stages": fk.stages, "axes": fk.axes,
        "codecs": codecs, "launches_per_call": per_call,
        "launches": launches, "ms_kernels": t_k, "ms_plain": t_p,
        "median_ms_kernels": statistics.median(t_k),
        "median_ms_plain": statistics.median(t_p),
        "bitwise_equal_to_plain": True,
        "max_abs_err_vs_exact": err.max().item(),
        "max_err_over_bound": (err / bound).max().item(),
        "compile_ms": compile_ms,
        "cost_model_program_time_s": fk.compiled.program_time(),
        "cost_model": COST_MODEL_NOTE,
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if cuda else None),
        "profile": device_profile(lambda: fk(x), RING_OPS) if cuda
        else None}


def hierarchical_path(mesh, cfg, seed: int, *, steps: int = 3,
                      expect_kernels: bool = True,
                      f2_local: int = F2_LOCAL) -> list[dict]:
    """The hierarchical phase on ``LocalMesh({"pod": 2, "data": 4})``:
    ``acis_hierarchical`` (:func:`main_path`, with its stream, serial and
    flat checks), ``acis_hierarchical_compressed`` with each compressor
    (:func:`compressed_path`), then F2's program (:func:`f2_path`)."""
    recs = [main_path(mesh, cfg, seed, steps=steps,
                      expect_kernels=expect_kernels,
                      backend="acis_hierarchical")]
    for comp in COMPRESSORS:
        recs.append(compressed_path(
            mesh, cfg, seed, comp, steps=steps,
            expect_kernels=expect_kernels,
            backend="acis_hierarchical_compressed"))
    recs.append(f2_path(mesh, seed, f2_local, steps=steps,
                        expect_kernels=expect_kernels))
    return recs


@dataclasses.dataclass(frozen=True)
class FusedSizes:
    """Per-rank sizes of the fused phase's programs (8 ranks)."""
    scan: int                  # fig5_scan, ag_map, map_rs: f32 per rank
    scan_2d: tuple             # fig5_scan_2d: [T, D] f32 per rank
    is_keys: int               # nas_is_c: int32 keys per rank
    is_max_key: int
    is_buckets: int
    gcn: tuple                 # (vertices, average degree, features)
    psgd: tuple                # (rows, cols, rank)


# Fig. 5's largest size (4 MiB per rank, benchmarks/figures.py:62); NPB IS
# class C (2^27 keys, max key 2^23, 2^10 buckets); Pubmed
# (benchmarks/figures.py:85-91); one acis-100m MLP matrix (d_model x d_ff)
FUSED = FusedSizes(scan=1 << 20, scan_2d=(16384, 64), is_keys=1 << 24,
                   is_max_key=1 << 23, is_buckets=1 << 10,
                   gcn=(19717, 4.5, 500), psgd=(768, 2048, 4))
# the same programs at sizes a CPU runs in seconds (a rehearsal only)
FUSED_SMOKE = FusedSizes(scan=5000, scan_2d=(300, 8), is_keys=64,
                         is_max_key=1 << 10, is_buckets=16,
                         gcn=(61, 4.5, 5), psgd=(32, 24, 4))


class FusedRun:
    """One run of the fused phase: the mesh, the timed steps and the
    records, one per program."""

    def __init__(self, mesh, seed: int, steps: int, expect_kernels: bool):
        self.mesh, self.steps = mesh, steps
        self.expect_kernels = expect_kernels
        self.dev = mesh.device
        self.cuda = self.dev.type == "cuda"
        self.n = mesh.axis_size("data")
        self.gen = torch.Generator(device=self.dev).manual_seed(seed + 13)
        self.records: list[dict] = []

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def timed(self, fn, *xs):
        self.sync()
        t0 = time.perf_counter()
        out = fn(*xs)
        self.sync()
        return out, (time.perf_counter() - t0) * 1e3

    def pair(self, name, prog, in_specs, out_specs, warm, inputs, compare,
             after=None) -> dict:
        """Compile ``prog`` for a kernel and a plain engine; call both on
        ``warm`` (untimed), then ``steps`` times on ``inputs`` in turns.
        ``compare(out_k, out_p, warm)`` checks one pair of outputs and
        returns its numbers; ``after(compiled, out_k)`` runs once the
        counts are read."""
        from repro_torch import core as acis

        if self.cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        eng_k = acis.make_engine("acis")
        check(eng_k.config.use_kernels, "use_kernels is off by default")
        eng_p = acis.make_engine("acis", use_kernels=False)
        fk = eng_k.compile(prog, self.mesh, in_specs, out_specs)
        fp = eng_p.compile(prog, self.mesh, in_specs, out_specs)
        check(fk.stages == fp.stages, f"{name}: stages differ")
        per_call = expected_launches(fk.compiled, self.mesh)
        reset_counts()
        (ok, _), (op, _) = in_turns(1, lambda: self.timed(fk, *warm),
                                    lambda: self.timed(fp, *warm))
        res = {"warm": compare(ok, op, True)}
        t_k, t_p = [], []
        for step in range(self.steps):
            (ok, dk), (op, dp) = in_turns(
                step, lambda: self.timed(fk, *inputs),
                lambda: self.timed(fp, *inputs))
            t_k.append(dk)
            t_p.append(dp)
            res[f"step{step}"] = compare(ok, op, False)
        launches = read_counts()
        if self.expect_kernels:
            check_launches(launches, per_call, self.steps + 1)
        if after is not None:
            res["after"] = after(fk.compiled, ok)
        rec = {"phase": "fused", "program": name, "stages": fk.stages,
               "launches_per_call": per_call, "launches": launches,
               "ms_kernels": t_k, "ms_plain": t_p,
               "median_ms_kernels": statistics.median(t_k),
               "median_ms_plain": statistics.median(t_p), "checks": res,
               "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                        if self.cuda else None),
               "profile": device_profile(lambda: fk(*inputs))
               if self.cuda else None}
        self.records.append(rec)
        return rec

    # -- the programs ----------------------------------------------------

    def fig5(self, name: str, local: tuple) -> None:
        from repro_torch import core as acis
        from repro_torch.mesh import P

        n, dev, gen = self.n, self.dev, self.gen
        shape = (n * local[0],) + tuple(local[1:])
        ints = torch.randint(-1, 2, shape, device=dev, generator=gen).float()
        x = torch.randn(shape, device=dev, generator=gen)
        exact_i = torch.cumsum(ints.double(), 0)
        exact, tol = scan_tolerance(x, 0)

        def compare(ok, op, warm):
            check(tuple(ok.shape) == shape and ok.dtype == torch.float32,
                  f"{name}: output {tuple(ok.shape)} {ok.dtype}")
            if warm:
                _bitwise_err(ok, op)
                check(torch.equal(ok.double(), exact_i),
                      f"{name}: integer-valued scan not exact")
                return {"bitwise": True}
            diff = (ok - op).abs()
            check(bool((diff <= 2 * tol).all()),
                  f"{name}: kernel and plain engines differ by "
                  f"{diff.max().item()}, beyond twice the bound")
            return {"kernels_err_over_bound": scan_err(ok, exact, tol, name),
                    "plain_err_over_bound": scan_err(op, exact, tol, name),
                    "max_abs_diff_vs_plain": diff.max().item()}

        def after(compiled, ok):
            # every rank's copy, from the rank-local program (one more
            # launch, after the counts were read): the ranks alike bit for
            # bit, the rerun within the stated bound (the look-back's
            # carries may round otherwise than in the last call: its
            # differing elements are counted, not held)
            with self.mesh:
                (ranks,) = compiled(x.reshape((n,) + tuple(local)))
            self.sync()
            for r in range(n):
                check(torch.equal(ranks[r], ranks[0]),
                      f"{name}: rank {r} holds another scan")
            return {"ranks_identical": True,
                    "rerun_err_over_bound": scan_err(ranks[0], exact, tol,
                                                     f"{name} rerun"),
                    "rerun_differing_elements": int((ranks[0] != ok).sum())}

        rec = self.pair(name, lambda v: acis.all_gather(acis.scan(
            acis.all_gather(v))), P("data"), P(None), (ints,), (x,),
            compare, after)
        rec.update(bytes_per_rank=math.prod(local) * 4,
                   local_shape=list(local))

    def nas_is(self, sizes: FusedSizes) -> None:
        """Per-rank bucket histogram of its keys beside the key exchange."""
        from repro_torch import core as acis
        from repro_torch.mesh import P

        n, dev = self.n, self.dev
        keys = torch.randint(0, sizes.is_max_key, (n * sizes.is_keys,),
                             device=dev, generator=self.gen,
                             dtype=torch.int32)
        shift = (sizes.is_max_key // sizes.is_buckets).bit_length() - 1
        bucket = (keys.view(n, -1) >> shift).long() \
            + torch.arange(n, device=dev)[:, None] * sizes.is_buckets
        hist = torch.bincount(bucket.view(-1),
                              minlength=n * sizes.is_buckets) \
            .view(n, sizes.is_buckets).float()
        del bucket
        want_h = hist.sum(0)
        want_k = keys.view(n, n, -1).transpose(0, 1).reshape(-1)

        def compare(ok, op, warm):
            for a, b in zip(ok, op):
                _bitwise_err(a, b)
            check(bool((ok[0] == want_h).all()), "nas_is_c: histogram sum")
            check(torch.equal(ok[1], want_k),
                  "nas_is_c: keys not delivered to their ranks")
            return {"bitwise": True}

        rec = self.pair("nas_is_c", lambda h, k: (acis.reduce(h),
                                                  acis.all_to_all(k)),
                        (P("data"), P("data")), (P("data"), P("data")),
                        (hist, keys), (hist, keys), compare)
        rec.update(keys_per_rank=sizes.is_keys, buckets=sizes.is_buckets,
                   bytes_per_rank=(sizes.is_keys + sizes.is_buckets) * 4)

    def map_programs(self, sizes: FusedSizes) -> None:
        """map+reduce_scatter and allgather+map of torch.square.  The
        scattered sums round n times (the squares once, n-1 ring adds),
        each by at most 2^-24 of the lane's Σx²; the gathered squares
        round once and equal torch.square bit for bit."""
        from repro_torch import core as acis
        from repro_torch.mesh import P

        n = self.n
        x = torch.randn((n * sizes.scan,), device=self.dev,
                        generator=self.gen)
        sq64 = x.double().square()
        rs_exact = sq64.view(n, -1).sum(0)
        want_sq = torch.square(x)

        def rs_compare(ok, op, warm):
            _bitwise_err(ok, op)
            err = (ok.double() - rs_exact).abs()
            check(bool((err <= n * 2.0 ** -24 * rs_exact).all()),
                  f"map_rs: {err.max().item()} off the float64 sum")
            return {"max_abs_err": err.max().item()}

        def ag_compare(ok, op, warm):
            _bitwise_err(ok, op)
            _bitwise_err(ok, want_sq)
            err = (ok.double() - sq64).abs()
            check(bool((err <= 2.0 ** -24 * sq64).all()),
                  "ag_map: squares off by more than one rounding")
            return {"bitwise_vs_square": True}

        for name, prog, out, compare in (
                ("map_rs", lambda v: acis.reduce_scatter(
                    acis.map(torch.square, v, name="square")), P("data"),
                 rs_compare),
                ("ag_map", lambda v: acis.map(
                    torch.square, acis.all_gather(v), name="square"),
                 P(None), ag_compare)):
            rec = self.pair(name, prog, P("data"), out, (x,), (x,), compare)
            rec.update(bytes_per_rank=sizes.scan * 4)

    def gcn(self, sizes: FusedSizes) -> None:
        """Â·X on a row-normalised random graph of the dataset's vertex
        count and average degree, padded to a multiple of the ranks:
        in-network (ring-rotated block MACs in a ``map`` body) and
        all-gather + one SpMM.  A row with m nonzeros is an addition tree
        over at most m products (zeros add exactly), so each output is
        within 2·m_max·2^-24·(Â·|X|) of the float64 product of the same
        f32 inputs, and the two programs within twice that of each
        other."""
        from repro_torch import core as acis
        from repro_torch.core import lookaside
        from repro_torch.mesh import P

        n, dev, gen = self.n, self.dev, self.gen
        verts, deg, feat = sizes.gcn
        rows = -(-verts // n)
        vp = rows * n
        edges = round(verts * deg / 2)
        src = torch.randint(0, verts, (edges,), device=dev, generator=gen)
        dst = torch.randint(0, verts, (edges,), device=dev, generator=gen)
        adj = torch.zeros((vp, vp), device=dev)
        adj[src, dst] = 1.0
        adj[dst, src] = 1.0
        adj /= adj.sum(1, keepdim=True).clamp_min(1.0)
        m_max = int((adj != 0).sum(1).max())
        x = torch.randn((vp, feat), device=dev, generator=gen)
        exact = adj.double() @ x.double()
        tol = 2 * m_max * 2.0 ** -24 * (adj @ x.abs()).double()
        blocks = adj.reshape(n, rows, n, rows).permute(0, 2, 1, 3) \
            .reshape(n * n, rows, rows)
        del adj, src, dst
        outs = {}

        def compare_to(name):
            def compare(ok, op, warm):
                _bitwise_err(ok, op)
                err = (ok.double() - exact).abs()
                check(bool((err <= tol).all()),
                      f"{name}: {err.max().item()} off the float64 product")
                outs[name] = ok
                return {"max_abs_err": err.max().item(),
                        "err_over_bound": (err / tol.clamp_min(1e-300))
                        .max().item()}
            return compare

        def spmm(ab, full):
            return torch.einsum("...brc,...bcd->...rd", ab, full.reshape(
                tuple(full.shape[:-2]) + (n, rows, feat)))

        recs = [
            self.pair("gcn_pubmed", lambda a, v: acis.map(
                lambda ab, xb: lookaside.gcn_aggregate(ab, xb, "data"),
                a, v, name="gcn_aggregate"), (P("data"), P("data")),
                P("data"), (blocks, x), (blocks, x),
                compare_to("gcn_pubmed")),
            self.pair("gcn_pubmed_baseline", lambda a, v: acis.map(
                spmm, a, acis.all_gather(v), name="spmm"),
                (P("data"), P("data")), P("data"), (blocks, x), (blocks, x),
                compare_to("gcn_pubmed_baseline"))]
        diff = (outs["gcn_pubmed"] - outs["gcn_pubmed_baseline"]).abs()
        check(bool((diff.double() <= 2 * tol).all()),
              f"gcn: in-network and baseline differ by {diff.max().item()}")
        for r in recs:
            r.update(vertices=verts, padded=vp, avg_degree=deg,
                     features=feat, max_row_nnz=m_max,
                     adj_blocks_bytes=blocks.numel() * 4,
                     max_abs_diff_in_network_vs_baseline=diff.max().item())

    def powersgd(self, sizes: FusedSizes) -> None:
        """Rank-r PowerSGD of one [rows, cols] matrix, called inside
        ``with mesh:``: one untimed step, then ``steps`` with q and the
        residual threaded, every rank holding the same reduced matrix;
        then the reference test's case — every rank holding one rank-r
        matrix, which one step recovers within rtol 0.03 and atol 0.03 of
        its largest entry."""
        from repro_torch.core import lookaside

        n, dev, gen = self.n, self.dev, self.gen
        rows, cols, r = sizes.psgd
        if self.cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        q = lookaside.powersgd_init((rows, cols), r, gen) \
            .expand(n, cols, r).contiguous()
        res = torch.zeros((n, rows, cols), device=dev)
        reset_counts()
        times = []
        with self.mesh:
            for step in range(-1, self.steps):
                m = torch.randn((n, rows, cols), device=dev, generator=gen)
                (red, q, res), dt = self.timed(
                    lookaside.powersgd_all_reduce, m, q, res, "data")
                check(bool(torch.isfinite(red).all()
                           and torch.isfinite(res).all()),
                      "powersgd: non-finite output")
                for i in range(1, n):
                    check(torch.equal(red[i], red[0]),
                          f"powersgd: rank {i} holds another result")
                if step >= 0:
                    times.append(dt)
            u = torch.randn((rows, r), device=dev, generator=gen)
            v = torch.randn((cols, r), device=dev, generator=gen)
            base = u @ v.T
            q0 = torch.randn((cols, r), device=dev, generator=gen)
            red, _, _ = lookaside.powersgd_all_reduce(
                base.expand(n, rows, cols).contiguous(),
                q0.expand(n, cols, r).contiguous(),
                torch.zeros((n, rows, cols), device=dev), "data")
        launches = read_counts()
        err = (red[0] - base).abs()
        check(bool((err <= 0.03 * base.abs().max()
                    + 0.03 * base.abs()).all()),
              f"powersgd: rank-{r} input recovered within "
              f"{err.max().item()}")
        self.records.append({
            "phase": "fused", "program": f"powersgd_r{r}",
            "shape": [rows, cols], "rank": r, "steps": self.steps,
            "launches": launches, "ms": times,
            "median_ms": statistics.median(times),
            "ranks_identical": True,
            "low_rank_max_abs_err": err.max().item(),
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if self.cuda else None)})


def fused_path(mesh, sizes: FusedSizes, seed: int, *, steps: int = 3,
               expect_kernels: bool = True) -> list[dict]:
    """The Type 3/4 programs through ``make_engine("acis").compile(prog,
    mesh, in_specs, out_specs)``, each run as :meth:`FusedRun.pair` says:

      * fig5_scan, fig5_scan_2d — AG∘scan∘AG (``scan+allgather``, its
        local scan the prefix_sum kernel): the untimed call on
        integer-valued data, bitwise equal to the plain engine and the
        exact sum; the timed ones on random normal data, each engine
        within :func:`scan_tolerance` of the float64 prefix sum; every
        rank holding the same result
      * nas_is_c — reduce(hist) + all_to_all(keys) (``allreduce+
        alltoall``): bitwise equal to the chunk transpose and the exact
        histogram sum
      * map_rs, ag_map — ``map+reduce_scatter`` / ``allgather+map``
      * gcn_pubmed, gcn_pubmed_baseline — :meth:`FusedRun.gcn`
      * powersgd_r4 — :meth:`FusedRun.powersgd`, a direct call

    Each program's launch counts are set to 0 just before its calls and
    read just after."""
    run = FusedRun(mesh, seed, steps, expect_kernels)
    run.fig5("fig5_scan", (sizes.scan,))
    run.fig5("fig5_scan_2d", sizes.scan_2d)
    run.nas_is(sizes)
    run.map_programs(sizes)
    run.gcn(sizes)
    run.powersgd(sizes)
    if expect_kernels:
        check(sum(r["launches"]["prefix_sum"] for r in run.records) > 0,
              "the fused programs launched no prefix_sum")
    return run.records


# ---------------------------------------------------------------------------
# phases 7-8: serving rwkv6-1.6b and recurrentgemma-9b
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeSizes:
    """A serve phase's traffic."""
    batch: int                 # Model.prefill / decode_step batch
    prompt: int                # prefill tokens per sequence
    steps: int                 # greedy decode steps after the prefill
    check_prompt: int          # prefill held against this many decode steps
    f32_steps: int             # decode steps of the f32 semantics check
    slots: int                 # ServeEngine slots
    requests: tuple            # ServeEngine: (prompt tokens, new tokens)
    long: tuple = ()           # (batch, prompt, steps) past the window


# 8 prompts of 512 tokens then 32 greedy steps; a continuous-batching mix
# of 8 requests (prompts 16-96, 16-32 new tokens) over 4 slots, so that 4
# requests land in reused slots
SERVE = ServeSizes(batch=8, prompt=512, steps=32, check_prompt=64,
                   f32_steps=8, slots=4,
                   requests=((16, 32), (96, 16), (40, 24), (72, 20),
                             (24, 28), (88, 16), (32, 32), (56, 24)))
# the same path at sizes a CPU runs in seconds (a rehearsal only)
SERVE_SMOKE = ServeSizes(batch=2, prompt=12, steps=3, check_prompt=6,
                         f32_steps=2, slots=2,
                         requests=((3, 4), (6, 3), (2, 5), (4, 2)))
# the hybrid phase: the same traffic, and 2 prompts of 2,560 tokens (past
# the 2,048-token window, so the ring wraps in prefill and decode) with 16
# decode steps
SERVE_HYBRID = dataclasses.replace(SERVE, long=(2, 2560, 16))
# its rehearsal at the smoke config's 16-token window: a 40-token long
# prompt, and a 20-token request that wraps the engine's ring
SERVE_HYBRID_SMOKE = dataclasses.replace(
    SERVE_SMOKE, requests=((3, 4), (6, 3), (20, 5), (4, 2)), long=(2, 40, 3))

# Two runs of the model that differ only in rounding order (kernel vs
# plain WKV sums; attention over a prompt vs a ring; a prompt prefilled at once vs token by token; a batch of
# four vs one in the matmuls) agree within this share of a row's largest
# |logit| (and of each cache leaf's largest magnitude).  bf16 weights, the
# served configuration: every op rounds to bf16, and a one-ulp flip
# anywhere spreads through the layers.  f32-cast weights, the semantics
# check: only f32 sums move.  A greedy token is compared only up to its
# row's first step whose top-2 gap is under twice the bound: a near-tie
# either run may break either way, and at the bf16 bound that is most
# steps of a random-weight model (the record's ``top2_gap_rel_median``).
# PERF.md gives the measured shares.
BF16_REL = 2.0 ** -4
F32_REL = 2.0 ** -14


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _top2_gap(lg: torch.Tensor) -> torch.Tensor:
    top = lg.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def hold_logits(want: list, got: list, rel: float) -> dict:
    """Logits of the same steps from two runs (the second fed the first
    one's tokens): each within ``rel`` of its row's largest |logit|, and
    the argmax equal up to each row's first near-tie in ``want``."""
    worst, compared, total = 0.0, 0, 0
    alive = None
    for a, b in zip(want, got):
        check(bool(torch.isfinite(b).all()), "non-finite logits")
        tol = rel * a.float().abs().amax(-1)
        err = ((b.float() - a.float()).abs().amax(-1) / tol).max().item()
        worst = max(worst, err)
        ok = _top2_gap(a) >= 2 * tol
        alive = ok if alive is None else alive & ok
        same = a.argmax(-1) == b.argmax(-1)
        check(bool(same[alive].all()), "greedy tokens differ before a "
              "near-tie")
        compared += int(alive.sum())
        total += alive.numel()
    check(worst <= 1, f"logits differ by {worst:.3g} x the bound "
          f"({rel} of the row's largest |logit|)")
    return {"logit_err_over_bound": worst, "tokens_compared": compared,
            "tokens": total}


def hold_cache(want, got, rel: float) -> float:
    """Every cache leaf within ``rel`` of its largest magnitude."""
    from repro_torch import tree

    worst = 0.0
    for a, b in zip(tree.tree_leaves(want), tree.tree_leaves(got)):
        a, b = a.float(), b.float()
        err = (b - a).abs().max().item() / (rel * a.abs().max()
                                            .clamp_min(1e-30).item())
        worst = max(worst, err)
    check(worst <= 1, f"cache differs by {worst:.3g} x the bound ({rel})")
    return worst


def run_model(model, params, toks, steps: int, dev, feed=None) -> dict:
    """``Model.prefill`` of ``toks`` then ``steps`` greedy
    ``decode_step``s (or the tokens in ``feed``), each bracketed by a
    device sync and timed on the host clock (the argmax is outside); the
    cache in the params' dtype."""
    b, t = toks.shape
    cache = model.init_cache(b, t + steps + 1, params["embed"].dtype,
                             device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    lg, cache = model.prefill(params, toks, cache)
    _sync(dev)
    out = {"prefill_ms": (time.perf_counter() - t0) * 1e3, "step_ms": [],
           "logits": [lg], "tokens": []}
    for i in range(steps):
        tok = lg.argmax(-1) if feed is None else feed[i]
        out["tokens"].append(tok)
        _sync(dev)
        t0 = time.perf_counter()
        lg, cache = model.decode_step(params, tok, cache, t + i)
        _sync(dev)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["logits"].append(lg)
    out["cache"] = cache
    return out


def prefill_vs_decode(model, params, toks, dev, rel: float) -> dict:
    """``prefill`` of ``toks`` held against as many ``decode_step``s: the
    last logits and every cache leaf within ``rel``."""
    b, t = toks.shape
    dt = params["embed"].dtype
    cache_a = model.init_cache(b, t + 1, dt, device=dev)
    lg_a, cache_a = model.prefill(params, toks, cache_a)
    cache_b = model.init_cache(b, t + 1, dt, device=dev)
    for i in range(t):
        lg_b, cache_b = model.decode_step(params, toks[:, i], cache_b, i)
    _sync(dev)
    out = hold_logits([lg_a], [lg_b], rel)
    out["cache_err_over_bound"] = hold_cache(cache_a, cache_b, rel)
    return out


class GapModel:
    """A model whose every decode step also records row 0's top-2 logit
    gap and twice the ``rel`` bound: a one-slot engine's near-ties."""

    def __init__(self, model, rel: float):
        self.model, self.rel, self.gaps = model, rel, []

    def init_cache(self, *a, **kw):
        return self.model.init_cache(*a, **kw)

    def decode_step(self, params, token, cache, index):
        lg, cache = self.model.decode_step(params, token, cache, index)
        self.gaps.append((_top2_gap(lg[0]).item(),
                          2 * self.rel * lg[0].float().abs().max().item()))
        return lg, cache


def serve_kernel(cfg) -> tuple[str, int]:
    """The recurrence kernel a serving model launches and how often per
    prefill call, decode step and engine tick: once per layer of its
    kind (``rwkv6_recurrence`` per rwkv layer, ``rglru_scan`` per lru
    layer)."""
    from repro_torch.models.transformer import layer_schedule

    kind, kernel = {"ssm": ("rwkv", "rwkv6_recurrence"),
                    "hybrid": ("lru", "rglru_scan")}[cfg.family]
    return kernel, layer_schedule(cfg).count(kind)


def check_serve_launches(got: dict, cfg, calls: int, what: str) -> None:
    """The model's kernel launched once per layer of its kind per call,
    and the other serving kernel not at all."""
    kernel, per = serve_kernel(cfg)
    for k in ("rwkv6_recurrence", "rglru_scan"):
        want = calls * per if k == kernel else 0
        check(got[k] == want, f"{what}: {k} launched {got[k]} times, "
              f"{calls} calls of {cfg.name} need {want}")


def cast_params_(params, dtype) -> None:
    """Cast every floating leaf of ``params`` to ``dtype`` in place, leaf
    by leaf, so that the old leaf is freed before the next is made."""
    for k, v in params.items():
        if isinstance(v, dict):
            cast_params_(v, dtype)
        elif v.is_floating_point():
            params[k] = v.to(dtype)


def engine_path(model, params, cfg, sizes: ServeSizes, seed: int, dev,
                rel: float, *, expect_kernels: bool = True,
                phase: str = "serve") -> dict:
    """``ServeEngine(slots)`` over the request mix, then each request
    alone in a fresh one-slot engine: the completions equal up to the
    fresh run's first step whose top-2 gap is under twice ``rel``
    (requests past the slot count land in reused slots)."""
    import numpy as np

    from repro_torch.obs import metrics
    from repro_torch.serve import Request, ServeEngine

    rng = np.random.default_rng(seed)
    reqs = [(i, rng.integers(0, cfg.vocab, p).astype(np.int32), n)
            for i, (p, n) in enumerate(sizes.requests)]
    max_seq = max(p + n for p, n in sizes.requests) + 2
    rec = metrics.Recorder()
    reset_counts()
    eng = ServeEngine(model, params, slots=sizes.slots, max_seq=max_seq,
                      recorder=rec)
    for rid, prompt, n_new in reqs:
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n_new))
    _sync(dev)
    t0 = time.perf_counter()
    done = eng.run_to_completion()
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = read_counts()
    if expect_kernels:
        check_serve_launches(launches, cfg, eng.ticks, "engine ticks")
    check([c.rid for c in done] == [r[0] for r in reqs]
          and [len(c.tokens) for c in done] == [n for _, _, n in reqs],
          "the engine did not complete every request in full")
    compared = 0
    for (rid, prompt, n_new), comp in zip(reqs, done):
        gm = GapModel(model, rel)
        alone = ServeEngine(gm, params, slots=1, max_seq=max_seq)
        alone.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n_new))
        want = alone.run_to_completion()[0].tokens
        for j, (a, b) in enumerate(zip(want, comp.tokens)):
            gap, tol = gm.gaps[len(prompt) - 1 + j]
            if gap < tol:
                break
            check(a == b, f"request {rid}: token {j} is {b}, a fresh "
                  f"engine gives {a}")
            compared += 1
    ticks = sorted(eng._tick_times)
    n_tok = sum(len(c.tokens) for c in done)
    kernel, per_tick = serve_kernel(cfg)
    return {
        "phase": phase, "program": "engine", "model": cfg.name,
        "dtype": str(params["embed"].dtype).replace("torch.", ""),
        "slots": sizes.slots, "requests": [list(r) for r in sizes.requests],
        "reused_slot_requests": max(0, len(reqs) - sizes.slots),
        "ticks": eng.ticks, "wall_s": wall, "generated_tokens": n_tok,
        "tokens_per_s": n_tok / wall,
        "tick_p50_ms": ticks[len(ticks) // 2] * 1e3,
        "tick_p99_ms": ticks[min(len(ticks) - 1,
                                 int(len(ticks) * 0.99))] * 1e3,
        "counters": {k: rec.counter(k) for k in (
            "serve.ticks", "serve.admitted", "serve.retired",
            "serve.host_sync")},
        "rel": rel, "fresh_engine_tokens_compared": compared,
        "launches": launches,
        "launches_per_tick": {kernel: per_tick},
    }


def long_prefill(model_k, model_p, params, cfg, sizes: ServeSizes, gen,
                 dev, rel: float) -> dict:
    """``sizes.long``: prompts past the window, prefilled and decoded with
    kernels on, then with ``use_kernels=False`` fed the same tokens;
    logits and every cache leaf (the wrapped rings included) within
    ``rel``."""
    b, t, steps = sizes.long
    toks = torch.randint(0, cfg.vocab, (b, t), device=dev, generator=gen)
    rk = run_model(model_k, params, toks, steps, dev)
    rp = run_model(model_p, params, toks, steps, dev, feed=rk["tokens"])
    out = hold_logits(rk["logits"], rp["logits"], rel)
    out["cache_err_over_bound"] = hold_cache(rk["cache"], rp["cache"], rel)
    out.update(batch=b, prompt=t, steps=steps,
               prefill_ms_kernels=rk["prefill_ms"],
               prefill_ms_plain=rp["prefill_ms"],
               decode_ms_per_step_kernels=statistics.median(rk["step_ms"]),
               decode_ms_per_step_plain=statistics.median(rp["step_ms"]))
    return out


def serve_path(cfg, seed: int, sizes: ServeSizes, *, device="cuda",
               expect_kernels: bool = True, phase: str = "serve"
               ) -> list[dict]:
    """A serving model at full width and depth on seeded random bf16
    weights (made on the device from ``seed``), the served configuration:

      * ``Model.prefill`` of ``batch`` prompts of ``prompt`` tokens, then
        ``steps`` greedy ``decode_step``s: one untimed warm-up pair, then
        two timed pairs in turns, kernels on and ``use_kernels=False``,
        both fed the warm-up's greedy tokens; logits held kernel vs plain
        within ``BF16_REL`` (:func:`hold_logits`)
      * :func:`prefill_vs_decode` on ``check_prompt`` tokens
      * :func:`long_prefill`, where ``sizes.long`` is set
      * a profile of one prefill and one decode step
      * :func:`engine_path`, timed

    then the same weights cast to f32 in place, the semantics check
    within ``F32_REL``: kernel vs plain over a prefill and ``f32_steps``
    decode steps, :func:`prefill_vs_decode`, :func:`long_prefill`, and
    :func:`engine_path` (slot reuse against fresh engines, where
    near-ties are rare).

    The model's recurrence kernel (:func:`serve_kernel`) must launch once
    per layer of its kind per prefill call, decode step and engine tick."""
    from repro_torch import tree
    from repro_torch.models import Model

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    model_k, model_p = Model(cfg), Model(cfg, use_kernels=False)
    check(model_k.use_kernels, "use_kernels is off by default")
    kernel, per_call = serve_kernel(cfg)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_k.init(gen, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree.tree_leaves(params))
    param_bytes = sum(x.numel() * x.element_size()
                      for x in tree.tree_leaves(params))
    toks = torch.randint(0, cfg.vocab, (sizes.batch, sizes.prompt),
                         device=dev, generator=gen)

    def counted(fn, calls: int, what: str):
        """``fn()`` with the counts set to 0 just before and read just
        after (:func:`check_serve_launches`)."""
        reset_counts()
        out = fn()
        got = read_counts()
        if expect_kernels:
            check_serve_launches(got, cfg, calls, what)
        return out, got

    # a warm-up pair (kernel free-running, plain fed its tokens), then
    # kernel and plain in turns, both fed the warm-up's tokens
    def timed_runs():
        warm_k = run_model(model_k, params, toks, sizes.steps, dev)
        feed = warm_k["tokens"]
        warm_p = run_model(model_p, params, toks, sizes.steps, dev,
                           feed=feed)
        held = [hold_logits(warm_k["logits"], warm_p["logits"], BF16_REL)]
        gaps = torch.cat([_top2_gap(lg) / lg.float().abs().amax(-1)
                          for lg in warm_k["logits"]])
        runs = []
        for step in range(2):
            rk, rp = in_turns(
                step, lambda: run_model(model_k, params, toks, sizes.steps,
                                        dev, feed=feed),
                lambda: run_model(model_p, params, toks, sizes.steps, dev,
                                  feed=feed))
            held.append(hold_logits(rk["logits"], rp["logits"], BF16_REL))
            runs.append((rk["prefill_ms"], rk["step_ms"], rp["prefill_ms"],
                         rp["step_ms"]))
        hold_cache(warm_p["cache"], rk["cache"], BF16_REL)
        return held, runs, gaps.median().item()

    (held, runs, gap_median), launches = counted(
        timed_runs, 3 * (1 + sizes.steps), "prefill and decode")
    short = toks[:, :sizes.check_prompt]
    vs_decode, launches_b = counted(
        lambda: prefill_vs_decode(model_k, params, short, dev, BF16_REL),
        1 + sizes.check_prompt, "prefill vs decode")
    launches = {k: launches[k] + launches_b[k] for k in launches}
    if sizes.long:
        long_held, launches_l = counted(
            lambda: long_prefill(model_k, model_p, params, cfg, sizes, gen,
                                 dev, BF16_REL),
            1 + sizes.long[2], "long prefill")
        launches = {k: launches[k] + launches_l[k] for k in launches}
    peak_mem = torch.cuda.max_memory_allocated() if cuda else None

    pre_k, pre_p = [r[0] for r in runs], [r[2] for r in runs]
    step_k = [t for r in runs for t in r[1]]
    step_p = [t for r in runs for t in r[3]]
    med = statistics.median
    ntok = sizes.batch * sizes.prompt
    record = {
        "phase": phase, "program": "prefill_decode", "model": cfg.name,
        "params": n_params, "param_bytes": param_bytes,
        "init_s": init_s, "batch": sizes.batch, "prompt": sizes.prompt,
        "steps": sizes.steps,
        "prefill_ms_kernels": pre_k, "prefill_ms_plain": pre_p,
        "prefill_tokens_per_s_kernels": ntok / med(pre_k) * 1e3,
        "prefill_tokens_per_s_plain": ntok / med(pre_p) * 1e3,
        "decode_ms_per_step_kernels": med(step_k),
        "decode_ms_per_step_plain": med(step_p),
        "decode_tokens_per_s_kernels": sizes.batch / med(step_k) * 1e3,
        "decode_tokens_per_s_plain": sizes.batch / med(step_p) * 1e3,
        "bf16_rel": BF16_REL,
        "kernel_vs_plain": {
            "logit_err_over_bound": max(h["logit_err_over_bound"]
                                        for h in held),
            "tokens_compared": sum(h["tokens_compared"] for h in held),
            "tokens": sum(h["tokens"] for h in held)},
        "top2_gap_rel_median": gap_median,
        "prefill_vs_decode": vs_decode,
        "max_memory_allocated": peak_mem,
        "kernel": kernel,
        "launches_per_call": {"prefill": per_call, "decode_step": per_call},
    }
    if sizes.long:
        record["long_prefill"] = long_held
    if cuda:
        cache = model_k.init_cache(sizes.batch, sizes.prompt + 2,
                                   device=dev)
        record["profile"] = {
            "prefill": device_profile(lambda: model_k.prefill(
                params, toks, cache)),
            "decode_step": device_profile(lambda: model_k.decode_step(
                params, toks[:, 0], cache, sizes.prompt))}
        del cache
    eng = engine_path(model_k, params, cfg, sizes, seed, dev, BF16_REL,
                      expect_kernels=expect_kernels, phase=phase)

    # the semantics check: the same weights in f32, cast leaf by leaf
    cast_params_(params, torch.float32)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def f32_runs():
        rk = run_model(model_k, params, toks, sizes.f32_steps, dev)
        rp = run_model(model_p, params, toks, sizes.f32_steps, dev,
                       feed=rk["tokens"])
        out = hold_logits(rk["logits"], rp["logits"], F32_REL)
        out["cache_err_over_bound"] = hold_cache(rk["cache"], rp["cache"],
                                                 F32_REL)
        return out

    f32_held, launches_c = counted(f32_runs, 1 + sizes.f32_steps,
                                   "f32 kernel vs plain")
    f32_vs_decode, launches_d = counted(
        lambda: prefill_vs_decode(model_k, params, short, dev, F32_REL),
        1 + sizes.check_prompt, "f32 prefill vs decode")
    launches = {k: launches[k] + launches_c[k] + launches_d[k]
                for k in launches}
    record["f32_check"] = {"rel": F32_REL, "steps": sizes.f32_steps,
                           "kernel_vs_plain": f32_held,
                           "prefill_vs_decode": f32_vs_decode}
    if sizes.long:
        record["f32_check"]["long_prefill"], launches_e = counted(
            lambda: long_prefill(model_k, model_p, params, cfg, sizes, gen,
                                 dev, F32_REL),
            1 + sizes.long[2], "f32 long prefill")
        launches = {k: launches[k] + launches_e[k] for k in launches}
    eng32 = engine_path(model_k, params, cfg, sizes, seed, dev, F32_REL,
                        expect_kernels=expect_kernels, phase=phase)
    record["f32_check"]["max_memory_allocated"] = \
        torch.cuda.max_memory_allocated() if cuda else None
    record["launches"] = launches
    eng["program"], eng32["program"] = "engine", "engine_f32"
    return [record, eng, eng32]


# ---------------------------------------------------------------------------
# phases 10-12: the simulator, the tuning loop and the elastic sync
# ---------------------------------------------------------------------------

# the cost model's figures (SimReport, program_time, a NetFit fitted from
# simulated traces) are for the paper's Table II switch, never card times
SIM_NOTE = ("SwitchSim's t_end / t_program_model / deviation are the cost "
            "model's times for the paper's Table II switch (PAPER_CGRA), "
            "not times on this card")

# the compiled syncs the sim phase runs: (backend, compressor, the sim's
# rank grid in topology order, inner axis first)
SIM_SYNCS = (("acis", None, {"data": 8}),
             ("acis_hierarchical", None, {"data": 4, "pod": 2}),
             ("acis_compressed", "int8_hopquant", {"data": 8}),
             ("acis_compressed", "topk", {"data": 8}))


def sim_expected_launches(compiled, sizes: dict) -> dict:
    """Each kernel's launches in one ``SwitchSim`` run of ``compiled``
    with kernels on, read off the plan: one elementwise ``fused_combine``
    per ring step (n-1 a reduce-scatter, a ring all-reduce of either
    schedule, a blockwise scan walk or a histogram ring over an axis of
    n), one ``quant_combine`` per step of an int8-coded all-reduce or an
    ``int8_hopquant`` EF stage, two ``topk_accumulate`` per ``topk`` EF
    stage (every rank's own vector, then every ring's shared sum), and one
    ``prefix_sum`` per inclusive-add ``scan+allgather``.  Every combine of
    these programs is add/max/min on f32 or bf16, the kernels' types."""
    out = dict.fromkeys(kernel_modules(), 0)
    for st in compiled.stages:
        n = sizes.get(st.axis, 1) if st.axis else 1
        kind = st.kind
        if kind in ("allreduce", "batched_allreduce", "map+allreduce"):
            codec = next(nd.op.codec for nd in st.ir.nodes
                         if nd.op.codec is not None
                         and nd.op.kind.name in ("REDUCE", "REDUCE_SCATTER"))
            key = "quant_combine" if codec.combine_encoded is not None \
                else "fused_combine"
            out[key] += max(n - 1, 0)
        elif kind in ("reduce_scatter", "map+reduce_scatter", "scan",
                      "allreduce+alltoall"):
            out["fused_combine"] += max(n - 1, 0)
        elif kind == "scan+allgather":
            scan = st.ir.nodes[1].op
            if scan.monoid.name == "add" and not scan.exclusive:
                out["prefix_sum"] += 1
            else:
                out["fused_combine"] += max(n - 1, 0)
        elif kind in ("ef_allreduce", "delivered"):
            comp = st.ir.nodes[0].op.ef.compressor
            if comp == "int8_hopquant":
                out["quant_combine"] += max(n - 1, 0)
            elif comp == "topk":
                out["topk_accumulate"] += 2
    return out


def _dev_sync(dev):
    return torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)


def _sim_grads(cfg, mesh, gen) -> dict:
    from repro_torch.configs.acis_100m import grad_leaf_specs

    return {k: torch.randn(mesh.rank_shape + shape, device=mesh.device,
                           generator=gen).to(dt)
            for k, shape, dt in grad_leaf_specs(cfg)}


def _topk_bound(target, residual, n: int, dtype) -> tuple:
    """``(exact, bound)`` of a top-k EF total per element: the float64 sum
    over the ranks of what each delivered (``target - residual``, exact:
    a selected lane's residual is 0), and the f32 rounding of summing n
    values in any order, ``n·2^-24·Σ|v|``, plus the total's rounding to
    the gradient's dtype."""
    d = target.double() - residual.double()
    exact = d.sum(0)
    eps = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
    return exact, n * 2.0 ** -24 * d.abs().sum(0) * (1 + eps) \
        + eps * exact.abs()


def sim_sync(cfg, seed: int, backend: str, compressor, sizes: dict, dev, *,
             steps: int = 3, expect_kernels: bool = True,
             dead: Optional[int] = None) -> dict:
    """One compiled sync through ``SwitchSim`` on the card: the engine's
    program executed once (kernels on) for the reference outputs, then
    ``steps`` simulated runs with kernels and with ``use_kernels=False``
    in turns, their launches counted and held to
    :func:`sim_expected_launches`.  Identity codecs and the int8 codecs
    are bitwise equal to the executed program and between the two sims;
    ``topk`` (atomics on the card) is held within ``n·2^-24·Σ|v|`` of the
    exact total an element (:func:`_topk_bound`).  With ``dead``, the
    masked sync under ``FaultPlan(dead={dead})``: its live ranks equal the
    executed masked sync with that rank dropped, bit for bit."""
    from repro_torch import core as acis
    from repro_torch import tree
    from repro_torch.cgra.simulate import FaultPlan, SwitchSim
    from repro_torch.elastic import Membership
    from repro_torch.mesh import LocalMesh

    mesh = LocalMesh(sizes, device=dev)
    sync_dev = _dev_sync(mesh.device)
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    gen = torch.Generator(device=mesh.device).manual_seed(seed + 31)
    grads = _sim_grads(cfg, mesh, gen)
    outer = "pod" if "pod" in sizes else None
    eng = acis.make_engine(backend, outer_axis=outer,
                           **({"compressor": compressor} if compressor
                              else {}))
    check(eng.config.use_kernels, "use_kernels is off by default")
    state = eng.init_state(grads)
    membership = None if dead is None \
        else Membership.all_alive(mesh.n_ranks).drop(dead)
    want, want_state = eng.gradient_sync(grads, state, mesh=mesh,
                                         membership=membership)
    compiled = eng.last_sync_program()
    leaves, treedef = tree.tree_flatten(grads)
    args = list(leaves)
    if eng.compressed:
        args += tree.tree_flatten(state)[0]
    if membership is not None:
        with mesh:
            args.append(eng._local_alive(membership))
    want_flat = tree.tree_flatten(want)[0] + (
        tree.tree_flatten(want_state)[0] if eng.compressed else [])
    faults = FaultPlan(dead={dead}, detect_timeout_s=1e-5) \
        if dead is not None else None
    sims = {uk: SwitchSim(compiled.topology, faults=faults, use_kernels=uk)
            for uk in (True, False)}
    per_run = sim_expected_launches(compiled, sizes)

    def run(uk):
        sync_dev()
        t0 = time.perf_counter()
        outs, rep = sims[uk].run(compiled, *args)
        sync_dev()
        return outs, rep, (time.perf_counter() - t0) * 1e3

    sync_dev()
    reset_counts()
    t_k, t_p = [], []
    for step in range(steps):
        (outs_k, rep_k, dk), (outs_p, rep_p, dp) = in_turns(
            step, lambda: run(True), lambda: run(False))
        t_k.append(dk)
        t_p.append(dp)
    launches = read_counts()
    if expect_kernels:
        check_launches(launches, per_run, steps)
    check(rep_k.t_end == rep_p.t_end and
          [s.t_sim for s in rep_k.stages] == [s.t_sim for s in rep_p.stages],
          "the simulated clock depends on use_kernels")

    live = torch.ones(mesh.n_ranks, dtype=torch.bool, device=mesh.device)
    if dead is not None:
        live[dead] = False
    worst_topk = 0.0
    n_ring = max(sizes.values())
    for i, (w, ok, op) in enumerate(zip(want_flat, outs_k, outs_p)):
        w, ok, op = (t.flatten(0, mesh.rank_ndim - 1)[live]
                     for t in (w, ok, op))
        check(tuple(ok.shape) == tuple(w.shape) and ok.dtype == w.dtype,
              f"output {i}: {tuple(ok.shape)} {ok.dtype}")
        check(bool(torch.isfinite(ok.float()).all()),
              f"output {i}: non-finite")
        if compressor == "topk" and i < len(leaves):
            # the synced mean: the total over n ranks, divided by n
            t = leaves[i].flatten(0, mesh.rank_ndim - 1).float()
            r = tree.tree_flatten(want_state)[0][i] \
                .flatten(0, mesh.rank_ndim - 1)
            exact, bound = _topk_bound(t, r, n_ring, w.dtype)
            for got in (ok, op, w):
                err = (got[0].double() * n_ring - exact).abs()
                check(bool((err <= bound).all()),
                      f"topk output {i}: {err.max().item()} off the exact "
                      "total, beyond n·2^-24·Σ|v|")
                worst_topk = max(worst_topk,
                                 (err / bound.clamp_min(1e-300)).max()
                                 .item())
            continue
        _bitwise_err(ok, w)
        _bitwise_err(op, w)
    deviations = [s.deviation for s in rep_k.stages
                  if s.deviation is not None]
    profile = device_profile(lambda: sims[True].run(compiled, *args),
                             RING_OPS) if mesh.device.type == "cuda" else None
    return {
        "phase": "sim", "program": backend + (f"[{compressor}]"
                                              if compressor else "")
        + ("[masked, dead rank %d]" % dead if dead is not None else ""),
        "grid": dict(sizes), "model": cfg.name,
        "stages": compiled.stage_kinds(),
        "launches_per_run": per_run, "launches": launches,
        "sim_ms_kernels": t_k, "sim_ms_plain": t_p,
        "median_sim_ms_kernels": statistics.median(t_k),
        "median_sim_ms_plain": statistics.median(t_p),
        "bitwise_to_executed": compressor != "topk",
        "topk_err_over_bound": worst_topk if compressor == "topk" else None,
        "cost_model_t_end_s": rep_k.t_end,
        "cost_model_t_program_model_s": rep_k.t_program_model,
        "cost_model_max_stage_deviation": max(deviations, default=None),
        "cost_model_rank_t_end_s": list(rep_k.rank_t_end),
        "cost_model": SIM_NOTE,
        "profile": profile,
    }


def sim_scan(seed: int, local: int, dev, *, steps: int = 3,
             expect_kernels: bool = True) -> dict:
    """Fig. 5's inclusive-add ``scan+allgather`` program (the fused phase's
    ``fig5_scan``) through ``SwitchSim`` on ``{"data": 8}``: one
    ``prefix_sum`` launch a run, every rank's copy and both sims within
    :func:`scan_tolerance` of the exact sum, as the executed program is;
    integer-valued data bitwise."""
    from repro_torch import core as acis
    from repro_torch.cgra.simulate import SwitchSim
    from repro_torch.mesh import LocalMesh

    mesh = LocalMesh({"data": 8}, device=dev)
    sync_dev = _dev_sync(mesh.device)
    gen = torch.Generator(device=mesh.device).manual_seed(seed + 37)
    compiled = acis.make_engine("acis").compile(
        lambda v: acis.all_gather(acis.scan(acis.all_gather(v))),
        in_avals=(acis.TensorSpec((local,), torch.float32),), axis_size=8)
    check(compiled.stage_kinds() == ["scan+allgather"], "fig5 stages")
    x = torch.randn((8, local), device=mesh.device, generator=gen)
    ints = torch.randint(-1, 2, (8, local), device=mesh.device,
                         generator=gen).float()
    exact, tol = scan_tolerance(x.reshape(-1), 0)
    with mesh:
        (want,) = compiled(x)
        (want_i,) = compiled(ints)
    sims = {uk: SwitchSim(compiled.topology, use_kernels=uk)
            for uk in (True, False)}
    per_run = sim_expected_launches(compiled, {"data": 8})

    def run(uk, v):
        sync_dev()
        t0 = time.perf_counter()
        out, rep = sims[uk].run(compiled, v)
        sync_dev()
        return out, rep, (time.perf_counter() - t0) * 1e3

    sync_dev()
    reset_counts()
    out_i, _, _ = run(True, ints)
    t_k, t_p = [], []
    for step in range(steps):
        (ok, rep, dk), (op, _, dp) = in_turns(
            step, lambda: run(True, x), lambda: run(False, x))
        t_k.append(dk)
        t_p.append(dp)
    launches = read_counts()
    if expect_kernels:
        check_launches(launches, per_run, steps + 1)
    _bitwise_err(out_i, want_i)
    check(torch.equal(out_i[0].double(), torch.cumsum(
        ints.reshape(-1).double(), 0)), "integer-valued scan not exact")
    ratios = [scan_err(t[0], exact, tol, name)
              for t, name in ((ok, "sim"), (op, "plain sim"),
                              (want, "executed"))]
    for r in range(8):
        check(torch.equal(ok[r], ok[0]), f"sim rank {r} holds another scan")
    return {"phase": "sim", "program": "fig5_scan", "grid": {"data": 8},
            "local": local, "stages": compiled.stage_kinds(),
            "launches_per_run": per_run, "launches": launches,
            "sim_ms_kernels": t_k, "sim_ms_plain": t_p,
            "median_sim_ms_kernels": statistics.median(t_k),
            "median_sim_ms_plain": statistics.median(t_p),
            "err_over_bound": {"sim": ratios[0], "plain_sim": ratios[1],
                               "executed": ratios[2]},
            "cost_model_t_end_s": rep.t_end,
            "cost_model_t_program_model_s": rep.t_program_model,
            "cost_model": SIM_NOTE}


def sim_path(cfg, seed: int, *, device="cuda", steps: int = 3,
             scan_local: int = 1 << 20,
             expect_kernels: bool = True) -> list[dict]:
    """The sim phase: every :data:`SIM_SYNCS` sync, the masked ``acis``
    sync with rank 3 dead, and Fig. 5's scan."""
    dev = torch.device(device)
    recs = [sim_sync(cfg, seed, b, c, s, dev, steps=steps,
                     expect_kernels=expect_kernels)
            for b, c, s in SIM_SYNCS]
    recs.append(sim_sync(cfg, seed, "acis", None, {"data": 8}, dev,
                         steps=steps, expect_kernels=expect_kernels, dead=3))
    recs.append(sim_scan(seed, scan_local, dev, steps=steps,
                         expect_kernels=expect_kernels))
    return recs


def tune_path(cfg, seed: int, *, device="cuda", runs: int = 3,
              expect_kernels: bool = True) -> dict:
    """The tuning loop on the card: ``record_instrumented`` of the ``acis``
    sync on ``{"data": 8}`` and the ``acis_hierarchical`` one on ``{"data":
    4, "pod": 2}``, ``runs`` each (CUDA-event spans: device time, one
    synchronize a run); ``fit_traces`` on them — a ``NetFit`` of the card,
    tagged with its name and power limit by the caller — then ``replay``
    under the fit against each measured ``t_end``; a ``chrome_trace``
    written to a temporary file and parsed back; ``DriftWatchdog`` on the
    traces against the fit; and ``make_engine("acis", autotune=True,
    tune_db=<temporary file>)``: the first sync searches and stores, a
    second engine hits the DB without searching, and the tuned mean is
    within the ring's rounding bound of the exact mean."""
    import tempfile

    from repro_torch import core as acis
    from repro_torch import obs, tune, tree
    from repro_torch.mesh import LocalMesh
    from repro_torch.obs import metrics as _metrics
    from repro_torch.obs.drift import DriftWatchdog

    # the package exports a function of the module's name
    _search = importlib.import_module("repro_torch.tune.search")

    dev = torch.device(device)
    sync_dev = _dev_sync(dev)
    out: dict = {"phase": "tune", "model": cfg.name, "runs": runs}
    reset_counts()
    samples, measured = [], {}
    for backend, sizes in (("acis", {"data": 8}),
                           ("acis_hierarchical", {"data": 4, "pod": 2})):
        mesh = LocalMesh(sizes, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed + 41)
        grads = _sim_grads(cfg, mesh, gen)
        eng = acis.make_engine(backend, outer_axis="pod" if "pod" in sizes
                               else None)
        eng.gradient_sync(grads, None, mesh=mesh)            # compile, warm
        compiled = eng.last_sync_program()
        leaves = tree.tree_flatten(grads)[0]
        with mesh:                       # one untimed instrumented run
            tune.record_instrumented(compiled, *leaves)
        traces = []
        for _ in range(runs):
            sync_dev()
            t0 = time.perf_counter()
            with mesh:
                _, tr = tune.record_instrumented(compiled, *leaves,
                                                 axes=dict(sizes))
            wall = (time.perf_counter() - t0) * 1e3
            check(len(tr.stages) == len(compiled.stages),
                  f"{backend}: {len(tr.stages)} spans for "
                  f"{len(compiled.stages)} stages")
            check(all(s.t_end >= s.t_start >= 0 for s in tr.stages),
                  f"{backend}: a span runs backwards")
            traces.append((tr, wall))
            samples.append((compiled.plan, compiled.topology, tr))
        measured[backend] = (compiled, traces)
        out[backend] = {
            "stages": len(compiled.stages),
            "t_end_ms": [tr.t_end * 1e3 for tr, _ in traces],
            "serial_ms": [tr.t_serial * 1e3 for tr, _ in traces],
            "wall_ms": [w for _, w in traces],
            "clock": "CUDA events (device time)" if dev.type == "cuda"
            else "perf_counter (host)"}
        del grads, leaves
    fit = tune.fit_traces(samples)
    out["fit"] = {
        "tiers": {t: {"bw_Bps": p.bw, "hop_s": p.fpga_link + p.port}
                  for t, p in fit.tiers.items()},
        "overlap": dict(fit.overlap), "detour_s": fit.detour,
        "host_bw_Bps": fit.host_bw, "residual": fit.residual,
        "n_stages": fit.n_stages, "dropped": list(fit.dropped)}
    for backend, (compiled, traces) in measured.items():
        pred = tune.replay(compiled.plan, None, compiled.topology,
                           fit=fit).t_end
        self_r = tune.replay(compiled.plan, traces[-1][0],
                             compiled.topology)
        meas = statistics.median(tr.t_end for tr, _ in traces)
        out[backend].update(replay_fit_ms=pred * 1e3,
                            measured_median_ms=meas * 1e3,
                            replay_over_measured=pred / meas,
                            self_replay_ms=self_r.t_end * 1e3,
                            self_replay_match=self_r.match_fraction)
    compiled, traces = measured["acis_hierarchical"]
    with tempfile.TemporaryDirectory() as tmp:
        path = obs.timeline.save(Path(tmp) / "sync.trace.json",
                                 traces[-1][0], compiled.plan)
        loaded = json.loads(Path(path).read_text())
    xs = [e for e in loaded["traceEvents"]
          if e["ph"] == "X" and e["name"] != "inject"]
    check(len(xs) == len(compiled.stages), "chrome trace lost a stage")
    check(sum(e["ph"] == "i" for e in loaded["traceEvents"])
          == compiled.plan.n_waves, "chrome trace lost a wave")
    out["chrome_trace"] = {"events": len(loaded["traceEvents"]),
                           "stage_slices": len(xs),
                           "lanes": sorted({e["tid"] for e in xs})}
    wd = DriftWatchdog()
    priced = sum(wd.observe(plan, fit.wrap(topo), tr)
                 for plan, topo, tr in samples)
    check(priced > 0, "the drift watchdog priced no span")
    verdict = wd.classify()
    out["drift"] = {"priced_spans": priced, "verdict": verdict.describe(),
                    "alerts": [a.describe() for a in wd.alerts()]}

    mesh = LocalMesh({"data": 8}, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 43)
    grads = _sim_grads(cfg, mesh, gen)
    with tempfile.TemporaryDirectory() as tmp:
        db = str(Path(tmp) / "tune.json")
        n0 = _search.SEARCHES_RUN
        with _metrics.recording() as rec:
            t0 = time.perf_counter()
            e1 = acis.make_engine("acis", autotune=True, tune_db=db)
            synced, _ = e1.gradient_sync(grads, None, mesh=mesh)
            search_s = time.perf_counter() - t0
            e2 = acis.make_engine("acis", autotune=True, tune_db=db)
            again, _ = e2.gradient_sync(grads, None, mesh=mesh)
        check(_search.SEARCHES_RUN == n0 + 1 and
              rec.counter("tune.db_search") == 1 and
              rec.counter("tune.db_hit") == 1,
              "the second autotuned compile did not hit the DB")
        entry = next(iter(json.loads(
            Path(db).read_text())["entries"].values()))
    check(e1.last_sync_program().stage_kinds()
          == e2.last_sync_program().stage_kinds(), "DB hit built another plan")
    n = mesh.n_ranks
    worst = 0.0
    for k, g in grads.items():
        o = synced[k]
        check(torch.equal(o, again[k]), f"{k}: tuned syncs differ")
        mean = g.float().mean(0)
        eps = 2.0 ** -7 if o.dtype == torch.bfloat16 else 2.0 ** -23
        bound = (n - 1) / 2 * eps * g.abs().float().sum(0) / n \
            + eps * mean.abs()
        dm = (o[0].float() - mean).abs()
        check(bool((dm <= bound).all()),
              f"{k}: the tuned sync is off the exact mean beyond the "
              "ring's rounding")
        worst = max(worst, (dm / bound.clamp_min(1e-30)).max().item())
    out["autotune"] = {"overrides": entry["overrides"],
                       "score_s": entry.get("score"),
                       "default_score_s": entry.get("default_score"),
                       "evals": entry.get("evals"),
                       "search_and_first_sync_s": search_s,
                       "db_hit": True, "err_over_ring_bound": worst,
                       "cost_model": "scores are replayed cost-model "
                       "times for the paper's switch"}
    out["launches"] = read_counts()
    return out


def elastic_path(cfg, seed: int, *, device="cuda", steps: int = 3,
                 expect_kernels: bool = True) -> list[dict]:
    """The elastic sync at full width: ``gradient_sync(membership=...)``
    with rank 3 of 8 dropped, on ``acis`` over ``{"data": 8}`` and
    ``acis_hierarchical`` over ``{"pod": 2, "data": 4}``; kernels against
    ``use_kernels=False`` bitwise, both within the flat sync's ring bound
    of the exact mean of the 7 live ranks; masked and unmasked sync ms in
    turns; ``recompile`` of the shape-preserving delta reusing program and
    arenas; then one ``sync_with_deadline`` whose rank times come from
    ``SwitchSim`` under a straggler ``FaultPlan`` (rank 5): it masks the
    straggler once and the retry is clean."""
    from repro_torch import core as acis
    from repro_torch import tree
    from repro_torch.cgra.simulate import FaultPlan, SwitchSim
    from repro_torch.elastic import Membership, sync_with_deadline
    from repro_torch.mesh import LocalMesh

    dev = torch.device(device)
    sync_dev = _dev_sync(dev)
    recs = []
    for backend, axes in (("acis", {"data": 8}),
                          ("acis_hierarchical", {"pod": 2, "data": 4})):
        mesh = LocalMesh(axes, device=dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        gen = torch.Generator(device=dev).manual_seed(seed + 47)
        grads = _sim_grads(cfg, mesh, gen)
        outer = "pod" if "pod" in axes else None
        eng_k = acis.make_engine(backend, outer_axis=outer)
        eng_p = acis.make_engine(backend, outer_axis=outer,
                                 use_kernels=False)
        mem = Membership.all_alive(mesh.n_ranks)
        dropped = mem.drop(3)
        ar_k = eng_k.init_arenas(grads, mesh=mesh, masked=True)
        per_sync = expected_launches(eng_k.last_sync_program(), mesh)
        ar_p = eng_p.init_arenas(grads, mesh=mesh, masked=True)
        ar_u = eng_k.init_arenas(grads, mesh=mesh)
        per_plain_sync = expected_launches(eng_k.last_sync_program(), mesh)
        with mesh:
            alive = eng_k._local_alive(dropped)
        live = alive.flatten() != 0

        def timed(eng, ar, membership):
            sync_dev()
            t0 = time.perf_counter()
            out = eng.gradient_sync(grads, None, arenas=ar, mesh=mesh,
                                    membership=membership)[0]
            sync_dev()
            return out, (time.perf_counter() - t0) * 1e3

        reset_counts()
        t_m, t_p, t_u = [], [], []
        for step in range(-1, steps):
            (ok, dk), (op, dp) = in_turns(
                step, lambda: timed(eng_k, ar_k, dropped),
                lambda: timed(eng_p, ar_p, dropped))
            _, du = timed(eng_k, ar_u, None)
            for k in grads:
                check(torch.equal(ok[k], op[k]),
                      f"{backend} masked: kernels differ from plain on {k}")
            if step >= 0:
                t_m.append(dk)
                t_p.append(dp)
                t_u.append(du)
        launches = read_counts()
        if expect_kernels:
            check_launches(launches, {k: per_sync[k] + per_plain_sync[k]
                                      for k in per_sync}, steps + 1)
        n_live = int(live.sum())
        worst = 0.0
        for k, g in grads.items():
            gl = g.flatten(0, mesh.rank_ndim - 1)[live].float()
            mean = gl.mean(0)
            o = ok[k].flatten(0, mesh.rank_ndim - 1)
            eps = 2.0 ** -7 if o.dtype == torch.bfloat16 else 2.0 ** -23
            bound = (mesh.n_ranks - 1) / 2 * eps * gl.abs().sum(0) \
                / n_live + eps * mean.abs()
            for r in range(mesh.n_ranks):
                d = (o[r].float() - mean).abs()
                check(bool((d <= bound).all()),
                      f"{backend} masked {k} rank {r}: off the live mean "
                      "beyond the ring's rounding")
                worst = max(worst, (d / bound.clamp_min(1e-30)).max().item())
        profile = {name: device_profile(lambda a=a, m=m: eng_k.gradient_sync(
            grads, None, arenas=a, mesh=mesh, membership=m), RING_OPS)
            for name, a, m in (("masked", ar_k, dropped),
                               ("unmasked", ar_u, None))} \
            if dev.type == "cuda" else None
        rep = eng_k.recompile(mem.delta(dropped), grads, mesh=mesh)
        check(rep.programs_reused == 1 and rep.arenas_reused == 1 and
              not rep.full_recompile, f"{backend}: recompile rebuilt")
        recs.append({
            "phase": "elastic", "backend": backend, "mesh": dict(axes),
            "model": cfg.name, "dead": [3], "live_ranks": n_live,
            "stages": eng_k.last_sync_program().stage_kinds(),
            "launches_per_masked_sync": per_sync, "launches": launches,
            "masked_ms_kernels": t_m, "masked_ms_plain": t_p,
            "unmasked_ms_kernels": t_u,
            "median_masked_ms_kernels": statistics.median(t_m),
            "median_masked_ms_plain": statistics.median(t_p),
            "median_unmasked_ms_kernels": statistics.median(t_u),
            "bitwise_kernels_vs_plain": True,
            "err_over_ring_bound": worst,
            "recompile": dataclasses.asdict(rep) | {
                "reuse_frac": rep.reuse_frac},
            "profile": profile})
        del grads, ok, op, ar_k, ar_p, ar_u

    # sync_with_deadline over SwitchSim rank times: the straggler's delay
    # lands on every hop it receives, so it finishes last; the deadline
    # sits between it and the rest
    mesh = LocalMesh({"data": 8}, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 53)
    grads = _sim_grads(cfg, mesh, gen)
    eng = acis.make_engine("acis")
    mem = Membership.all_alive(8)
    eng.gradient_sync(grads, None, mesh=mesh, membership=mem)
    compiled = eng.last_sync_program()
    leaves = tree.tree_flatten(grads)[0]

    def sim_times(m, faults):
        with mesh:
            flags = eng._local_alive(m)
        _, rep = SwitchSim(compiled.topology, faults=faults).run(
            compiled, *leaves, flags)
        return rep

    base = sim_times(mem, None).t_end
    slow = sim_times(mem, FaultPlan(straggler_s={5: base}))
    others = max(t for r, t in enumerate(slow.rank_t_end) if r != 5)
    check(slow.rank_t_end[5] > others, "the straggler is not last")
    deadline = 0.5 * (others + slow.rank_t_end[5])
    attempts = []

    def run(m, _deadline):
        faults = FaultPlan(straggler_s={5: base}) if m.alive[5] \
            else FaultPlan(dead={5})
        rep = sim_times(m, faults)
        synced = eng.gradient_sync(grads, None, mesh=mesh, membership=m)[0]
        attempts.append(rep.t_end)
        return synced, rep.rank_t_end

    reset_counts()
    outcome = sync_with_deadline(run, mem, deadline_s=deadline)
    launches = read_counts()
    check(outcome.attempts == 2 and outcome.masked == (5,),
          f"sync_with_deadline: {outcome.attempts} attempts, masked "
          f"{outcome.masked}")
    live = torch.ones(8, dtype=torch.bool, device=dev)
    live[5] = False
    for k, g in grads.items():
        mean = g[live].float().mean(0)
        eps = 2.0 ** -7 if g.dtype == torch.bfloat16 else 2.0 ** -23
        bound = 3.5 * eps * g[live].abs().float().sum(0) / 7 \
            + eps * mean.abs()
        check(bool(((outcome.result[k][0].float() - mean).abs()
                    <= bound).all()),
              f"deadline sync {k}: off the live mean")
    recs.append({"phase": "elastic", "program": "sync_with_deadline",
                 "model": cfg.name, "straggler": 5,
                 "attempts": outcome.attempts,
                 "masked": list(outcome.masked),
                 "cost_model_deadline_s": deadline,
                 "cost_model_attempt_t_end_s": attempts,
                 "cost_model": SIM_NOTE, "launches": launches})
    return recs


# device kernels of a ring sync counted by name: PyTorch's rolls and its
# index kernels (the per-rank gathers and the all-gather's puts), and the
# hand-written hops, combines and pack
RING_OPS = {"rolls": "roll_cuda_kernel",
            "gathers_and_puts": "index_elementwise_kernel",
            "fused_hop": "::hop_kernel", "fused_pack": "pack_kernel",
            "fused_combine": "::combine_kernel",
            "quant_hop": "quant_hop_kernel",
            "quant_combine": "quant_combine_kernel"}


def device_profile(step, count: Optional[dict] = None) -> dict:
    """One more sync under ``torch.profiler``: device time by
    kernel name (top 10) and the device's busy share of the window (sum
    of kernel times over the host wall time, profiler overhead
    included); with ``count`` ({label: name part}), the launches and ms
    of every kernel whose name holds each part.  A measurement only: a
    profiler that fails reports why."""
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
    counted = {label: {"launches": sum(c for k, (_, c) in by_name.items()
                                       if part in k),
                       "ms": sum(t for k, (t, _) in by_name.items()
                                 if part in k) / 1e3}
               for label, part in (count or {}).items()}
    return {"window_ms": wall_us / 1e3, "device_ms": busy / 1e3,
            "counted": counted,
            "device_busy_share": busy / wall_us if wall_us else None,
            "kernels": len(by_name),
            "launches": sum(c for _, c in by_name.values()),
            "top": [{"name": n[:90], "ms": t / 1e3, "count": c}
                    for n, (t, c) in top]}


# ---------------------------------------------------------------------------

COMPRESSORS = ("int8", "int8_hopquant", "topk")
# the kernels the main paths run: the fused_combine and quant_combine
# sources' ring-hop forms on the executed syncs, their elementwise forms on
# the sim phase (SwitchSim's one launch a ring step)
SOURCES = {
    "fused_combine": ("src/repro_torch/kernels/csrc/fused_combine.cu",
                      "src/repro/kernels/fused_combine.py:70"),
    "fused_hop": ("src/repro_torch/kernels/csrc/fused_combine.cu",
                  "src/repro/kernels/fused_combine.py:70"),
    "fused_pack": ("src/repro_torch/kernels/csrc/fused_pack.cu",
                   "src/repro/kernels/pack_combine.py:68"),
    "quant_combine": ("src/repro_torch/kernels/csrc/quant_combine.cu",
                      "src/repro/kernels/quant_combine.py:55"),
    "quant_hop": ("src/repro_torch/kernels/csrc/quant_combine.cu",
                  "src/repro/kernels/quant_combine.py:55"),
    "topk_accumulate": ("src/repro_torch/kernels/csrc/topk_accum.cu",
                        "src/repro/kernels/topk_accum.py:47"),
    "prefix_sum": ("src/repro_torch/kernels/csrc/prefix_sum.cu",
                   "src/repro/kernels/chunk_scan.py:64"),
    "rwkv6_recurrence": ("src/repro_torch/kernels/csrc/rwkv6_recurrence.cu",
                         "src/repro/kernels/rwkv6_recurrence.py:83"),
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "src/repro/kernels/chunk_scan.py:113"),
}


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
    from repro_torch.configs.recurrentgemma_9b import CONFIG as RGEMMA
    from repro_torch.configs.rwkv6_1_6b import CONFIG as RWKV6
    from repro_torch.kernels import build
    from repro_torch.mesh import LocalMesh

    # full float32 matmuls (the GCN and PowerSGD programs, and their
    # float64-held bounds), stated and set rather than left to defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = []
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    peak, f32_peak, peak_note = device_peaks(name)
    nvcc_v = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip()
    rec = {"phase": "env", "torch": torch.__version__,
           "cuda": torch.version.cuda, "python": sys.version.split()[0],
           "nvidia_smi": smi, "device": name,
           "device_count": torch.cuda.device_count(),
           "nvcc": nvcc_v.splitlines()[-1],
           "ninja_on_path": shutil.which("ninja") is not None,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "hbm_peak_Bps": peak, "f32_peak_flops": f32_peak,
           "peak_source": peak_note}
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
    timings = kernel_timings(dev, peak, f32_peak, CONFIG, RWKV6, RGEMMA)
    rec = {"phase": "kernels", "checks": checks, "timings": timings}
    emit(rec)
    records.append(rec)

    mesh = LocalMesh({"data": 8}, device="cuda")
    paths = [main_path(mesh, CONFIG, args.seed)]
    emit(paths[-1])
    for comp in COMPRESSORS:
        paths.append(compressed_path(mesh, CONFIG, args.seed, comp))
        emit(paths[-1])
    for rec in fused_path(mesh, FUSED, args.seed):
        paths.append(rec)
        emit(rec)
    del mesh
    for rec in hierarchical_path(LocalMesh({"pod": 2, "data": 4},
                                           device="cuda"),
                                 CONFIG, args.seed):
        paths.append(rec)
        emit(rec)
    for rec in sim_path(CONFIG, args.seed, scan_local=FUSED.scan):
        paths.append(rec)
        emit(rec)
    rec = tune_path(CONFIG, args.seed)
    rec["card"] = smi
    paths.append(rec)
    emit(rec)
    for rec in elastic_path(CONFIG, args.seed):
        paths.append(rec)
        emit(rec)
    for rec in serve_path(RWKV6, args.seed, SERVE):
        paths.append(rec)
        emit(rec)
    for rec in serve_path(RGEMMA, args.seed, SERVE_HYBRID,
                          phase="serve_hybrid"):
        paths.append(rec)
        emit(rec)
    records.extend(paths)

    kernels = []
    for k, (src, replaces) in SOURCES.items():
        launches = sum(p["launches"][k] for p in paths)
        check(launches > 0, f"{k} was launched on no main path")
        t = timings[k]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches,
            "max_abs_err": checks[k]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            **({"sector_bound_ms": t["sector_bound_ms"]}
               if "sector_bound_ms" in t else {})})
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
