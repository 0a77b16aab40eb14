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
                  data 4 (``HOP_VIEWS``); ``fused_gather`` bitwise
                  against the ring's put and shift loop on the same views,
                  chunks on and off the 16-byte grid, and at the
                  whisper-small sync's largest and smallest all-gathers;
                  bf16 ``mac`` within one bf16 ulp;
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
                  within ``rglru_tolerance``; ``flash_attention``, forward
                  and gradients, within one bf16 ulp of the plain loop,
                  two runs bitwise equal, its f32 O far under the error
                  of a P rounded to bf16), then timed at the main
                  path's shapes with CUDA events beside its plain version,
                  one PyTorch library call computing the same function
                  where there is one, and its bound (bytes over the
                  memory rate, or f32 operations over the f32 rate; for
                  the attention kernel, which replaces no TPU kernel,
                  tensor-core operations over the bf16 peak, forward and
                  backward apart, at whisper-small's encoder shape and
                  deepseek-v2-lite's per-head latent attention)
  4. acis       — the acis-100m gradient sync at full width (12 leaves,
                  124,668,672 parameters per rank, 8 ranks on one
                  ``LocalMesh``): ``make_engine("acis")`` with kernels on,
                  ``init_arenas``, one untimed warm-up sync per engine,
                  then 3 timed syncs in turns with the same sync at
                  ``use_kernels=False`` (which goes first alternates);
                  bitwise equal to it, within bf16
                  rounding of the ``xla`` backend and of the exact f32
                  mean; arenas written in place; every ring hop launched
                  ``fused_hop``, every ring all-gather ``fused_gather``
                  (with use_kernels off too: its dispatch reads only the
                  device) and every bucket pack ``fused_pack``, as
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
  11. train     — acis-100m trained at full width (``train_path``): on
                  ``LocalMesh({"data": 8})`` 3 steps each of ``acis`` and
                  ``acis_compressed`` with int8, int8_hopquant and topk,
                  and of ``acis_hierarchical`` on ``{"pod": 2, "data":
                  4}``, from one seeded state: each step's per-rank
                  gradients (one forward and one backward over
                  rank-expanded params, ``train_e2e``'s 8 x 256 batch)
                  synced and applied with kernels and with
                  ``use_kernels=False``, bitwise equal (synced gradients,
                  residuals, params, optimizer state), every rank's
                  synced gradients equal (``rank_agreement``), launches as
                  the plan says x steps; then ``examples/torch_train_e2e.py``'s
                  ``main`` (its default ``acis_compressed`` int8 on
                  ``LocalMesh({"data": 4})``, AdamW with
                  ``warmup_cosine(3e-4, 20, 200)``, ``BigramStream(seed=
                  7)``): 200 steps, a checkpoint every 50, the example's
                  own assert that the nll falls by more than 0.5; a fresh
                  run from the twin's ``setup`` restored from step 100,
                  run to 200 and bitwise equal to the straight run
                  (params, optimizer state, EF residual; deterministic
                  algorithms on); step ms, tokens/s, peak memory and one
                  profiled step split into forward + backward, sync and
                  optimizer
  12. serve      — rwkv6-1.6b at full width and depth (24 layers, d_model
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
  13. serve_hybrid — recurrentgemma-9b at full width and depth (38 layers:
                  12 x (lru, lru, window) + (lru, lru); d_model 4096, 16
                  query heads and 1 KV head of 256, lru_width 4096, conv
                  width 4, window 2048, d_ff 12288 GeGLU, vocab 256,000)
                  through the same checks, plus 2 prompts of 2,560 tokens
                  (past the window) and 16 decode steps, kernels against
                  plain; ``rglru_scan`` launched once per lru layer (26)
                  per prefill call, decode step and engine tick
  14. serve_tp_dense — qwen3-8b at full width, cut to 18 of its 36 layers
                  (for the run's time, PERF.md §4; d_model 4096, 32 query
                  and 8 KV heads of 128, qk-norm, SwiGLU d_ff 12288,
                  vocab 151,936) served tensor-parallel
                  on ``LocalMesh({"tp": 8})`` through ``ServeCollectives``:
                  the params split once, a batched 8 x 512 prefill and 32
                  greedy decode ticks in five modes in turns (compiled
                  switch programs with kernels and with
                  ``use_kernels=False``, direct acis rings, the plain
                  reduction, the unsharded model), compiled bitwise equal
                  without kernels and to direct, every mode within
                  ``BF16_REL`` of the unsharded logits, ``fused_hop`` /
                  ``fused_combine`` launched as the programs predict; a
                  profile of one tick; ``ServeEngine(slots=8,
                  collectives=)`` over 16 requests (``tp_serve_path``)
  15. serve_tp_moe — qwen2-moe-a2.7b at full width (d_model 2048, 16
                  heads of 128, 60 routed experts top-4 of d_ff 1408,
                  shared experts of 5632, vocab 151,936), 16 of its 24
                  layers (cut for the run's time, PERF.md §4), on
                  ``LocalMesh({"tp": 4})``: the same with a 4 x 64
                  prefill (decode ticks, as the reference prefills a MoE
                  stack); the tick's all-to-all and its Type-4
                  ``allreduce+alltoall`` combine (shared-expert reduce
                  and the expert all-to-all in one stage)
  16. serve_mla — deepseek-v2-236b at full width (d_model 5120, 128
                  heads, MLA kv_lora 512 / q_lora 1536 / rope 64 / nope
                  128 / v 128, 160 routed experts top-6 of d_ff 1536, 2
                  shared of 3072, the dense layer's d_ff 12288, vocab
                  102,400) cut to 2 layers (1 dense + 1 MoE, bf16; the
                  config's 60 are about 472 GB): an 8 x 32 prefill (decode
                  ticks, the reference's prefill of a MoE stack) and 32
                  greedy decode steps, ``Model.forward`` (no MoE drops)
                  against prefill + decode within ``BF16_REL``, a profile
                  of one decode step, ``ServeEngine(slots=4)`` over 8
                  requests held against fresh one-slot engines; then on a
                  fresh f32 model of the same depth forward vs
                  decode within ``F32_REL``, the engine again (f32 has
                  few near-ties to stop its comparison), one MLA layer's
                  absorbed
                  attention against per-head keys and values
                  materialized from the latents, and the latent cache's
                  bytes a token against a 128-head GQA cache's
                  (``zoo_serve_path``)
  17. serve_encdec — whisper-small at full width and depth (12 + 12
                  layers, d_model 768, 12 heads, GELU 3072, LayerNorm,
                  vocab 51,865) with a 1,500-frame ``synthetic_context``
                  in bf16: the same traffic and checks (no engine: the
                  reference's reads no context, ROADMAP.md R6), a second
                  context moving the logits by more than ``BF16_REL``,
                  decode steps timed re-encoding the context (as the
                  reference's ``Model`` does on every call) and encoded
                  once; the f32 check on the weights cast in place
  18. serve_vlm — llama-3.2-vision-11b at full width and depth (40
                  layers = 8 x (cross, self x 4), d_model 4096, 32 / 8
                  heads of 128, SwiGLU 14336, vocab 128,256, 1,601 image
                  tokens), its cross gates drawn non-zero: as serve_encdec
                  with a 4 x 32 prefill; f32 by casting the weights in
                  place (about 42 GB)
  19. train_encdec — whisper-small trained at full width on
                  ``LocalMesh({"data": 8})``, one 256-token sequence and
                  its [1500, 768] bf16 context a rank: 3 steps each of
                  ``acis`` and ``acis_compressed`` int8_hopquant, kernels
                  against ``use_kernels=False`` bitwise, the ranks
                  agreeing, launches as the plan says x steps; then 20
                  steps of ``acis`` with AdamW ``warmup_cosine(3e-4, 5,
                  20)``, the nll of step 20 below step 1, step ms,
                  tokens/s, peak memory and one profiled step
                  (``train_encdec_path``)
  20. train_gspmd — acis-100m at full width and depth through
                  ``build_train_step_gspmd`` on ``LocalMesh({"data": 4,
                  "model": 2})`` (train_e2e's ``--backend xla`` mesh; FSDP
                  over data, wq/wk/wv/wi column- and wo row-split over
                  model, native gathers, sums and slices): every leaf's
                  shard shape as ``param_specs`` says; 3 f32 steps against
                  the acis step with ``make_engine("xla")`` on ``{"data":
                  4}`` (nll within 1e-3, params within 2.5e-2); 60 steps
                  of train_e2e's traffic with ``warmup_cosine(3e-4, 20,
                  60)`` whose nll must fall by 0.5; one step's collective
                  log by kind equal to ``launch.cells.build_train``'s count
                  of the same step on the meta device; step ms, tokens/s
                  and one profiled step (forward + backward, collectives,
                  optimizer) (``train_gspmd_path``)
  21. pipeline  — acis-100m's 12 blocks in 4 stages of 3 through
                  ``run_pipeline`` on ``LocalMesh({"pipe": 4})``, 8
                  embedded microbatches of 1 x 256 (11 ticks): bf16 and
                  f32 against the blocks in sequence (``BF16_REL`` /
                  ``F32_REL`` of the largest magnitude), then the int8
                  wire codec with every handoff within half the codec's
                  per-block absmax step and every stage's output the
                  stage applied to what it received (``pipeline_path``)
  22. seq_parallel — ``rglru_scan_sp`` over ``LocalMesh({"data": 8})`` at
                  recurrentgemma-9b's lru_width 4,096, f32, batch 1, T =
                  524,288 (65,536 steps a rank, 8.6 GB each for a and b):
                  one ``rglru_scan`` launch for every rank's chunk, held
                  against one launch over the whole T and, on 64 lanes,
                  a float64 recurrence within ``sp_tolerance``; ms
                  against the whole launch (``seq_parallel_path``)
  23. dryrun    — ``python -m repro_torch.launch.dryrun`` for qwen3-8b x
                  train_4k on the single-pod mesh (probes composed) and
                  the multi-pod mesh, on the host's CPU in two processes
                  started after the build and read at the end: the
                  bottleneck, the three roofline terms (the cost model's
                  against one H100's published peaks, not card times),
                  ``useful_flops_ratio`` and the seconds each took
                  (``dryrun_start`` / ``dryrun_finish``)
  24. examples  — the port's entry points, ``examples/torch_*.py``, each
                  through its ``main`` on the card (before the dry run's
                  records): the quickstart (its qwen3-8b at 18 layers of
                  full width, serve_tp_dense's cut), the Types 0-4 tour,
                  the hierarchical sync (each program also run on the
                  mesh), the simulator and batched serving (acis-100m at
                  full width, two TP=2 replicas); the examples' asserts,
                  each printed number held as ``<name>_checks`` says, the
                  kernels of ``EXAMPLE_KERNELS`` launched, host seconds
                  and peak memory (``examples_path``); ``train_e2e``'s
                  record points at the train phase's run of it

The serving phases 16-18 launch none of the ported kernels (the
reference's paths for these families reach no Pallas kernel): their
launches are checked to be zero.  Phases 20, 21 and 23 launch none either;
phase 22's ``rglru_scan`` launch counts toward the kernels line.

Each path's launch counts are set to 0 just before it runs and read just
after; launches made to compare a kernel with its plain version are not
counted.  The ring all-gather takes its kernel on the card whatever
``use_kernels`` says, so the paths' kernel-against-plain comparisons hold
it against itself: every form of gather that phases 4-24 launch is noted
(:class:`GatherPlans`), and after them a ``gather_plans`` line holds
``fused_gather`` against the ring's put and shift loop at each, bit for
bit.  Then the ``{"kernels": [...]}`` line, the card's name and
power limit as ``nvidia-smi`` reports them, and, last, ``{"ok": true,
"device": ...}``.
Any failed check raises: the exit code is non-zero and no ``ok`` line is
printed.  Without a CUDA device, or without the repository around it, the
script stops before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

ROOT = Path(__file__).resolve().parent

# device-memory, float32 (outside the tensor cores) and dense bf16
# tensor-core peaks by card name (NVIDIA data sheets): the bound_ms
# denominators.
PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 756e12,
     "H100 PCIe: 2.0 TB/s HBM2e, 51 TFLOP/s f32, 756 TFLOP/s bf16 dense"),
    ("H100", 3.35e12, 67e12, 989e12,
     "H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s f32, 989 TFLOP/s bf16 dense"),
    ("H200", 4.8e12, 67e12, 989e12,
     "H200: 4.8 TB/s HBM3e, 67 TFLOP/s f32, 989 TFLOP/s bf16 dense"),
)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_peaks(name: str) -> tuple[float, float, float, str]:
    """``(bytes/s, f32 flop/s, bf16 tensor flop/s, source)`` of the card
    called ``name``."""
    for key, hbm, f32, tensor, note in PEAKS:
        if key in name:
            return hbm, f32, tensor, note
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
    count there, by kernel name (``fused_combine`` holds three kernels,
    ``quant_combine`` and ``chunk_scan`` two each)."""
    from repro_torch.kernels import (chunk_scan, flash_attention,
                                     fused_combine, pack_combine,
                                     quant_combine, rwkv6_recurrence,
                                     topk_accum)
    return {"fused_combine": (fused_combine, "launches"),
            "fused_hop": (fused_combine, "hop_launches"),
            "fused_gather": (fused_combine, "gather_launches"),
            "fused_pack": (pack_combine, "launches"),
            "quant_combine": (quant_combine, "launches"),
            "quant_hop": (quant_combine, "hop_launches"),
            "topk_accumulate": (topk_accum, "launches"),
            "prefix_sum": (chunk_scan, "launches"),
            "rwkv6_recurrence": (rwkv6_recurrence, "launches"),
            "rglru_scan": (chunk_scan, "rglru_launches"),
            "flash_attention": (flash_attention, "launches")}


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
    report["fused_gather"] = gather_checks(data)
    report["quant_combine"] = quant_checks(dev, gen)
    report["quant_hop"] = quant_hop_checks(dev, gen)
    report["topk_accumulate"] = topk_checks(dev, gen)
    report["prefix_sum"] = prefix_checks(dev, gen)
    report["rwkv6_recurrence"] = wkv_checks(dev, gen)
    report["rglru_scan"] = rglru_checks(dev, gen)
    report["flash_attention"] = attention_checks(dev)
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


def gather_checks(data) -> dict:
    """``fused_gather`` against the ring loop it replaces
    (``ring._ring_all_gather_loop``: puts and shifts through the
    transport), bit for bit and one launch a call: f32, bf16 and int8, on
    every view of ``HOP_VIEWS`` and on ``{"data": 1}``, at chunks whose
    segments lie on the 16-byte grid (4096) and off it (1003, 3 x 5),
    each from the start of its allocation and one element in; then the
    whisper-small sync's largest and smallest all-gathers on
    ``{"data": 8}`` (bf16 chunks of 4,979,040 and 43,008, f32 of
    11,904)."""
    from repro_torch.core import ring
    from repro_torch.kernels import fused_combine as fc
    from repro_torch.mesh import LocalMesh

    report = {"cases": 0, "max_abs_err": 0.0}

    def hold(mesh, first, ax):
        with mesh:
            want = ring._ring_all_gather_loop(first, ax)
        n0 = fc.gather_launches
        got = fc.fused_gather(first, dim=mesh.dim(ax),
                              rank_ndim=mesh.rank_ndim)
        torch.cuda.synchronize()
        check(fc.gather_launches == n0 + 1,
              f"a gather made {fc.gather_launches - n0} launches")
        report["cases"] += 1
        report["max_abs_err"] = max(report["max_abs_err"], _bitwise_err(
            got.view(torch.int8), want.view(torch.int8)))

    for axes, ax in HOP_VIEWS + (({"data": 1}, "data"),):
        mesh = LocalMesh(axes, device="cuda")
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            for chunk in ((4096,), (1003,), (3, 5)):
                for offset in (0, 1):
                    shape = mesh.rank_shape + chunk
                    flat = data((math.prod(shape) + offset,), dtype)
                    hold(mesh, flat[offset:].view(shape), ax)
    mesh = LocalMesh({"data": 8}, device="cuda")
    for chunk, dtype in ((4_979_040, torch.bfloat16),
                         (43_008, torch.bfloat16), (11_904, torch.float32)):
        hold(mesh, data((8, chunk), dtype), "data")
    return report


class GatherPlans:
    """Every ring all-gather launched between :meth:`start` and
    :meth:`stop`, noted by all that the gather kernel's
    result depends on: the mesh's axes and rank shape, the ring's axis,
    the chunks' shape and dtype, and where their bytes start on the
    16-byte grid.  The gather's dispatch reads only the device, so a
    ``use_kernels=False`` sync on the card launches the kernel too and a
    phase's kernel-against-plain comparison cannot see a fault of it:
    :meth:`hold` holds the kernel against the ring's loop at each noted
    form instead."""

    def start(self) -> "GatherPlans":
        from repro_torch.kernels import fused_combine as fc
        from repro_torch.mesh import current

        self.seen: dict = {}
        self.kernel = fc.fused_gather

        def noted(first, *, dim, rank_ndim):
            tp = current()
            key = (tp.axis_names, tp.rank_shape, tp.axis_names[dim],
                   tuple(first.shape), first.dtype,
                   first.data_ptr() % 16)
            self.seen[key] = self.seen.get(key, 0) + 1
            return self.kernel(first, dim=dim, rank_ndim=rank_ndim)
        fc.fused_gather = noted
        return self

    def stop(self) -> None:
        from repro_torch.kernels import fused_combine as fc

        fc.fused_gather = self.kernel

    def hold(self, device="cuda") -> dict:
        """``fused_gather`` against ``ring._ring_all_gather_loop`` at every
        noted form, fresh random chunks as many bytes off the grid as the
        noted ones, bit for bit and one launch each."""
        from repro_torch.core import ring
        from repro_torch.kernels import fused_combine as fc
        from repro_torch.mesh import LocalMesh

        gen = torch.Generator(device=device).manual_seed(31)
        dtypes = set()
        for names, rank_shape, ax, shape, dtype, off in self.seen:
            mesh = LocalMesh(dict(zip(names, rank_shape)), device=device)
            nbytes = math.prod(shape) * dtype.itemsize
            buf = torch.empty(nbytes + 16, dtype=torch.uint8, device=device)
            first = buf[off:off + nbytes].view(dtype).view(shape)
            if dtype.is_floating_point:
                first.copy_(torch.randn(shape, device=device, generator=gen))
            else:
                info = torch.iinfo(dtype)
                first.copy_(torch.randint(info.min, info.max, shape,
                                          device=device, generator=gen,
                                          dtype=dtype))
            with mesh:
                want = ring._ring_all_gather_loop(first, ax)
            n0 = fc.gather_launches
            got = fc.fused_gather(first, dim=mesh.dim(ax),
                                  rank_ndim=mesh.rank_ndim)
            bad = (got.view(torch.uint8) != want.view(torch.uint8)).sum()
            check(bad.item() == 0, f"the gather of {shape} {dtype} over "
                  f"{ax} of {mesh.axes} ({off} bytes off the grid) differs "
                  f"from the loop in {bad.item()} bytes")
            check(device != "cuda" or fc.gather_launches == n0 + 1,
                  f"a gather made {fc.gather_launches - n0} launches")
            dtypes.add(str(dtype).removeprefix("torch."))
            del buf, first, want, got
        check(bool(self.seen), "no ring all-gather was launched")
        return {"phase": "gather_plans", "forms": len(self.seen),
                "gathers": sum(self.seen.values()),
                "dtypes": sorted(dtypes),
                "off_grid": sum(1 for k in self.seen if k[-1]),
                "max_abs_err": 0.0}


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


# (name, q shape, k shape, v width, causal, window, q_offset): the
# benchmark's whisper-small encoder, decoder and cross attention,
# acis-100m GQA and deepseek-v2-lite's latent attention in its per-head
# form (keys 192 wide, values 128) with the rank dim in front, and the
# edge forms (one query row, ragged keys, a window, head dim 128)
ATTENTION_CASES = (
    ("whisper_encoder", (8, 4, 1500, 12, 64), (8, 4, 1500, 12, 64), 64,
     False, None, 0),
    ("whisper_cross", (8, 4, 256, 12, 64), (8, 4, 1500, 12, 64), 64, False,
     None, 0),
    ("whisper_decoder", (8, 4, 256, 12, 64), (8, 4, 256, 12, 64), 64, True,
     None, 0),
    ("acis_100m_gqa", (8, 8, 256, 12, 64), (8, 8, 256, 4, 64), 64, True,
     None, 0),
    ("mla_per_head", (8, 2, 4096, 16, 192), (8, 2, 4096, 16, 192), 128,
     True, None, 0),
    ("one_row", (3, 1, 4, 64), (3, 77, 2, 64), 64, True, None, 76),
    ("ragged_window_d128", (2, 200, 4, 128), (2, 173, 1, 128), 128, True, 70,
     0),
)
# whisper-small's encoder self attention in the benchmark's train cell:
# 8 ranks x 4 segments of 1,500 frames, 12 heads of 64
ATTENTION_TIMED = ((8, 4, 1500, 12, 64), False)
# head dim 128: qwen3-8b's causal GQA prefill in serve_tp_dense (and the
# quickstart), 8 x 512 tokens, 32 / 8 heads over tp = 8 ranks: q, then k/v
ATTENTION_TIMED_D128 = ((8, 8, 512, 4, 128), (8, 8, 512, 1, 128))
# keys 192 and values 128: deepseek-v2-lite's per-head latent attention in
# the benchmark's train cell, 8 ranks x 2 rows of 4,096, 16 heads, causal:
# q and k, then v
ATTENTION_TIMED_WIDE = ((8, 2, 4096, 16, 192), (8, 2, 4096, 16, 128))


def attention_checks(dev, cases=ATTENTION_CASES) -> dict:
    """The fused attention kernel against the plain loop on the same bf16
    operands, forward and the q, k, v gradients: within one bf16 ulp plus
    1e-5 of the largest magnitude (both round an f32 value once; the f32
    values differ by summation order).  Then its f32 O against a float64
    dense reference beside the plain f32 form's error and the error a P
    rounded to one bf16 would give (the f32 operands reach the tensor
    cores in full: the kernel's error sits with the f32 form's, far under
    the bf16 one's)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as TA

    gen = torch.Generator(device=dev).manual_seed(4321)
    rep = {"cases": 0, "max_abs_err": 0.0, "max_err_over_tol": 0.0,
           "o32": {}}
    for name, qs, ks, dv, causal, window, off in cases:
        q, k, v = (torch.randn(s, device=dev, generator=gen).bfloat16()
                   for s in (qs, ks, ks[:-1] + (dv,)))
        do = torch.randn(qs[:-1] + (dv,), device=dev,
                         generator=gen).bfloat16()
        scale = 1 / math.sqrt(qs[-1])
        kw = dict(causal=causal, window=window, q_offset=off)
        check(FA.takes(q, k, v, kv_len=None, **kw),
              f"attention {name}: the dispatch rule refused the kernel")

        def run(fn):
            a, b, c = (x.clone().requires_grad_() for x in (q, k, v))
            out = fn(a, b, c)
            return (out, *torch.autograd.grad(out, (a, b, c), do))
        n0 = FA.launches
        got = run(lambda a, b, c: TA.flash_attention(a, b, c, **kw))
        check(FA.launches == n0 + 1, f"attention {name}: no kernel launch")
        want = run(lambda a, b, c: TA.plain_flash_attention(
            a, b, c, kv_len=None, chunk=1024, scale=scale, **kw))
        again = run(lambda a, b, c: TA.flash_attention(a, b, c, **kw))
        for g, w, g2 in zip(got, want, again):
            check(torch.equal(g, g2), f"attention {name}: two runs differ")
            err = (g.double() - w.double()).abs()
            tol = 2.0 ** -7 * w.double().abs() \
                + 1e-5 * w.double().abs().max()
            over = (err / tol).max().item()
            check(over <= 1, f"attention {name}: {over} x its tolerance")
            rep["max_abs_err"] = max(rep["max_abs_err"], err.max().item())
            rep["max_err_over_tol"] = max(rep["max_err_over_tol"], over)
        rep["cases"] += 1

        hi, lo = FA.mask_bounds(causal, window, off)
        flat = [x.reshape((-1,) + x.shape[-3:])[:2] for x in (q, k, v)]
        _, o32, _ = FA.forward(*flat, hi=hi, lo=lo, scale=scale)
        exact, _ = FA.plain_forward(*(x.double() for x in flat), hi=hi, lo=lo,
                                    scale=scale)
        f32, _ = FA.plain_forward(*flat, hi=hi, lo=lo, scale=scale)
        p, _ = FA.plain_probs(*(x.double() for x in flat[:2]), hi=hi, lo=lo,
                              scale=scale)
        bf16_p = torch.einsum("...hgqk,...khd->...qhgd",
                              p.bfloat16().double(), flat[2].double()
                              ).reshape(exact.shape)
        big = exact.abs().max().item()
        errs = {k_: (x.double() - exact).abs().max().item() / big
                for k_, x in (("kernel", o32), ("plain_f32", f32),
                              ("bf16_p", bf16_p))}
        check(errs["kernel"] * 8 <= errs["bf16_p"],
              f"attention {name}: the f32 O is not far under a bf16 P's "
              f"error: {errs}")
        rep["o32"][name] = errs
    return rep


def attention_timings(dev, peak: float, tc_peak: float,
                      timed=ATTENTION_TIMED,
                      timed_d128=ATTENTION_TIMED_D128,
                      timed_wide=ATTENTION_TIMED_WIDE) -> dict:
    """The fused attention kernel at whisper-small's encoder shape
    (:func:`attention_timed`); ``d128_prefill`` the forward at head dim
    128 beside the plain loop; ``wide`` the kernels at keys 192 and
    values 128, deepseek-v2-lite's per-head latent attention, as at
    whisper's shape."""
    shape, causal = timed
    out = attention_timed(dev, peak, tc_peak, shape, shape, causal, seed=77)
    out["d128_prefill"] = attention_d128(dev, peak, tc_peak, timed_d128)
    out["wide"] = attention_timed(dev, peak, tc_peak, *timed_wide, True,
                                  seed=79)
    torch.cuda.empty_cache()
    return out


def attention_timed(dev, peak: float, tc_peak: float, shape, v_shape,
                    causal: bool, seed: int) -> dict:
    """The fused attention kernel on q and k of ``shape`` and v of
    ``v_shape`` (one KV head a query head), forward (``ms``) and
    backward (``bwd_ms``) apart, beside the plain loop (``plain_ms``, and
    forward + backward through autograd) and
    ``scaled_dot_product_attention`` (``library_ms``: a yardstick only,
    the port never calls it; it rounds P to bf16).  ``bound_ms`` is the
    attention's own operations (:func:`flash_attention.work`'s ``plain``
    counts: 2(d + dv) a visible pair forward, 2(3d + 2dv) backward) over
    the bf16 tensor peak, or the bytes over the memory rate where
    larger; ``impl_bound_ms`` counts the kernels' own products instead,
    the f32 operands' three parts each."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as TA

    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(s, device=dev, generator=gen).bfloat16()
                   for s in (shape, shape, v_shape, v_shape))
    scale = 1 / math.sqrt(shape[-1])
    hi, lo = FA.mask_bounds(causal, None, 0)
    kw = dict(hi=hi, lo=lo, scale=scale)
    flat = [x.reshape((-1,) + x.shape[-3:]) for x in (q, k, v, do)]
    nb, t, h, d = flat[0].shape
    dv = v_shape[-1]
    _, o32, lse = FA.forward(*flat[:3], **kw)

    def fwd_bwd(fn, reps=None):
        def step():
            a, b, c = (x.detach().requires_grad_() for x in (q, k, v))
            torch.autograd.grad(fn(a, b, c), (a, b, c), do)
        return time_ms(step, **(reps or {}))

    def plain(a, b, c):
        return TA.plain_flash_attention(a, b, c, causal=causal, window=None,
                                        q_offset=0, kv_len=None, chunk=1024,
                                        scale=scale)

    def sdpa(a, b, c):
        return torch.nn.functional.scaled_dot_product_attention(
            *(x.reshape((nb,) + x.shape[-3:]).transpose(1, 2)
              for x in (a, b, c)), is_causal=causal).transpose(1, 2
                                                              ).reshape(
                                                                  v_shape)
    few = {"reps": 5, "inner": 2}
    work = FA.work(nb, t, t, h, d, hi, dv=dv)
    qk, vo, rows = q.numel(), v.numel(), nb * h * t
    # forward: q, k, v read, O written in bf16 and f32, the LSE written;
    # backward: q, k, v, dO read, the f32 O, LSE and D, dq, dk, dv written
    fwd_bytes = 2 * qk * 2 + vo * (2 + 2 + 4) + rows * 4
    bwd_bytes = 2 * qk * 2 * 2 + vo * (2 * 2 + 2 + 4) + rows * 8
    out = {
        "ms": time_ms(lambda: FA.forward(*flat[:3], **kw)),
        "bwd_ms": time_ms(lambda: FA.backward(*flat[:3], o32, lse, flat[3],
                                              **kw)),
        "fwd_bwd_ms": fwd_bwd(lambda a, b, c: TA.flash_attention(
            a, b, c, causal=causal, window=None, q_offset=0,
            softmax_scale=scale)),
        "plain_ms": time_ms(lambda: plain(q, k, v), **few),
        "plain_fwd_bwd_ms": fwd_bwd(plain, few),
        "library_ms": time_ms(lambda: sdpa(q, k, v)),
        "library_fwd_bwd_ms": fwd_bwd(sdpa),
        "device_ms_per_launch": per_launch(
            lambda: FA.forward(*flat[:3], **kw), "fwd_kernel", calls=10),
        "flops": work["forward"], "bwd_flops": work["backward"],
        "attention_flops": work["plain_forward"],
        "attention_bwd_flops": work["plain_backward"],
        "bytes": fwd_bytes, "bwd_bytes": bwd_bytes,
        "shape": list(shape), "v_shape": list(v_shape), "causal": causal,
        "dtype": "bfloat16", "tensor_peak_flops": tc_peak,
    }
    for key, flops, nbytes in (
            ("bound_ms", work["plain_forward"], fwd_bytes),
            ("bwd_bound_ms", work["plain_backward"], bwd_bytes),
            ("impl_bound_ms", work["forward"], fwd_bytes),
            ("impl_bwd_bound_ms", work["backward"], bwd_bytes)):
        out[key] = max(flops / tc_peak, nbytes / peak) * 1e3
    out["bound_by"] = "operations" if work["plain_forward"] / tc_peak \
        >= fwd_bytes / peak else "bytes"
    for key in ("", "bwd_", "impl_", "impl_bwd_"):
        out[f"{key}share_of_bound"] = out[f"{key}bound_ms"] \
            / out["bwd_ms" if "bwd" in key else "ms"]
    del q, k, v, do, flat, o32, lse
    torch.cuda.empty_cache()
    return out


def attention_d128(dev, peak: float, tc_peak: float, shapes) -> dict:
    """The fused attention forward at head dim 128 (the serving
    prefills' form: causal GQA, no backward) beside the plain loop, with
    the attention's own operations over the bf16 tensor peak."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as TA

    qs, ks = shapes
    gen = torch.Generator(device=dev).manual_seed(78)
    q, k, v = (torch.randn(s, device=dev, generator=gen).bfloat16()
               for s in (qs, ks, ks))
    scale = 1 / math.sqrt(qs[-1])
    flat = [x.reshape((-1,) + x.shape[-3:]) for x in (q, k, v)]
    nb, t, h, d = flat[0].shape
    work = FA.work(nb, t, t, h, d, 0)
    # q read, O written in bf16 and f32, k and v read, the LSE written
    nbytes = q.numel() * (2 + 2 + 4) + 2 * k.numel() * 2 + nb * h * t * 4
    out = {
        "ms": time_ms(lambda: FA.forward(*flat, hi=0, lo=None, scale=scale)),
        "plain_ms": time_ms(lambda: TA.plain_flash_attention(
            q, k, v, causal=True, window=None, q_offset=0, kv_len=None,
            chunk=1024, scale=scale), reps=5, inner=2),
        "flops": work["plain_forward"], "impl_flops": work["forward"],
        "bytes": nbytes, "shape": [list(qs), list(ks)], "causal": True,
        "dtype": "bfloat16",
    }
    out["bound_ms"] = max(out["flops"] / tc_peak, nbytes / peak) * 1e3
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    return out


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
    step, at the same [8, 3,072,000] add), the whisper-small sync's
    largest ring all-gather ([8, 4,979,040] bf16 chunks into every rank's
    [8, 4,979,040] result, beside the puts and shifts it replaced,
    ``loop_ms``), the Coalesce bucket pack (f32 parts
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
    from repro_torch.core import ring
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
    # the whisper-small sync's largest ring all-gather: every rank's chunk
    # of its 39,832,320-element bucket into each rank's result; its plain
    # version is the index formula, ``loop_ms`` the ring's puts and shifts
    # it replaced, the library call one copy from a broadcast view
    first = torch.randn((8, 4_979_040), device=dev,
                        generator=gen).bfloat16()
    whole = torch.empty((8, 8, 4_979_040), device=dev, dtype=torch.bfloat16)
    with mesh:
        loop_ms = time_ms(lambda: ring._ring_all_gather_loop(first, "data"),
                          reps=5)
    gather = {
        "ms": time_ms(lambda: fc.fused_gather(first, dim=0, rank_ndim=1)),
        "plain_ms": time_ms(lambda: fc.gather_plain(first, dim=0,
                                                    rank_ndim=1)),
        "library_ms": time_ms(lambda: whole.copy_(
            first.unsqueeze(0).expand(8, 8, 4_979_040))),
        "loop_ms": loop_ms,
        "device_ms_per_launch": per_launch(
            lambda: fc.fused_gather(first, dim=0, rank_ndim=1),
            "gather_kernel"),
        "bytes": 9 * first.numel() * first.element_size(),
        "shape": [8, 4_979_040], "dtype": "bfloat16",
    }
    del first, whole
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
    out = {"fused_combine": comb, "fused_hop": hop, "fused_gather": gather,
           "fused_pack": pack,
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
    out["flash_attention"] = attention_timings(
        dev, peak, device_peaks(torch.cuda.get_device_name(0))[2])
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
    ring and on a fused ``allreduce+alltoall`` stage's reduce, whose
    operand is f32 or bf16 on every path here; n-1 quant hops on an
    int8-coded ring), one pack launch per
    ``MAX_PARTS`` parts of an arena pack, n-1 quant hops per
    int8_hopquant EF stage, and per top-k EF stage one accumulate of the
    rank's own payload, n-1 of the hops' and one for the decompress, and
    one prefix_sum (every rank's local scan at once) per inclusive-add
    scan+allgather stage.  One gather launch per ring all-gather over an
    axis of n > 1: a bandwidth all-reduce's second half (of a plain
    ``allreduce``, ``batched_allreduce`` or ``map+allreduce`` stage, one
    per encoded leaf of an int8-coded ring, whatever its schedule: the
    blocks and the scales), an ``allgather``, ``allgather+map`` or
    ``scan+allgather`` stage, and an EF stage's int8 rings (the int8
    compressor's one int16 leaf, int8_hopquant's two)."""
    from repro_torch.kernels import pack_combine as pc

    # the plan counts the collective's kernels: the model's attention
    # kernel runs in no stage
    out = {k: 0 for k in kernel_modules() if k != "flash_attention"}
    for st in compiled.stages:
        n = mesh.axis_size(st.axis) if st.axis else 1
        gathers = 0
        if st.kind == "scan+allgather":
            scan = st.ir.nodes[1].op
            if scan.monoid.name == "add" and not scan.exclusive:
                out["prefix_sum"] += 1
        if st.kind in ("allgather", "allgather+map", "scan+allgather"):
            gathers = 1
        if st.kind == "map+allreduce":
            gathers = 2 if st.ir.nodes[-1].op.codec.combine_encoded \
                is not None else int(st.schedule == "bandwidth")
        if st.kind in ("allreduce", "batched_allreduce"):
            codec = st.ir.nodes[-1].op.codec
            if codec.combine_encoded is not None:
                out["quant_hop"] += n - 1         # the int8 wire's ring
                gathers = 2
            else:
                hop = "fused_hop" if st.schedule == "bandwidth" \
                    else "fused_combine"
                out[hop] += n - 1
                gathers = int(st.schedule == "bandwidth")
        if st.kind == "reduce_scatter":
            out["fused_hop"] += n - 1
        if st.kind == "allreduce+alltoall":
            out["fused_combine"] += n - 1
        if st.arena_slot is not None:
            out["fused_pack"] += -(-pack_parts(st) // pc.MAX_PARTS)
        if st.kind in ("ef_allreduce", "delivered"):
            comp = st.ir.nodes[0].op.ef.compressor
            if comp == "int8_hopquant":
                out["quant_hop"] += n - 1
                gathers = 2
            elif comp == "topk":
                out["topk_accumulate"] += n + 1
            elif comp == "int8":
                gathers = 1
        if n > 1:
            out["fused_gather"] += gathers
    return out


def with_plain_gathers(per_run: dict) -> dict:
    """``per_run`` for a window where a kernel run and a
    ``use_kernels=False`` run of the same plan take turns: the gather
    kernel takes every ring all-gather on the card, whatever
    ``use_kernels`` says (its dispatch reads only the device), so both
    runs launch the plan's gathers; the other kernels launch in the
    kernel run alone."""
    return {**per_run, "fused_gather": 2 * per_run["fused_gather"]}


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
        check_launches(launches, with_plain_gathers(per_sync), steps + 1)
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
        check_launches(launches, with_plain_gathers(per_sync), steps + 1)
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
        check_launches(launches, with_plain_gathers(per_call), steps + 1)
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
            check_launches(launches, with_plain_gathers(per_call),
                           self.steps + 1)
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


def run_model(model, params, toks, steps: int, dev, feed=None,
              context=None) -> dict:
    """``Model.prefill`` of ``toks`` then ``steps`` greedy
    ``decode_step``s (or the tokens in ``feed``), each bracketed by a
    device sync and timed on the host clock (the argmax is outside); the
    cache in the params' dtype.  ``context`` (encdec / vlm) goes to every
    call, which re-encodes it as the reference's ``Model`` does."""
    b, t = toks.shape
    kw = {} if context is None else {"context": context}
    cache = model.init_cache(b, t + steps + 1, params["embed"].dtype,
                             device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    lg, cache = model.prefill(params, toks, cache, **kw)
    _sync(dev)
    out = {"prefill_ms": (time.perf_counter() - t0) * 1e3, "step_ms": [],
           "logits": [lg], "tokens": []}
    for i in range(steps):
        tok = lg.argmax(-1) if feed is None else feed[i]
        out["tokens"].append(tok)
        _sync(dev)
        t0 = time.perf_counter()
        lg, cache = model.decode_step(params, tok, cache, t + i, **kw)
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
    layer); ``(None, 0)`` for the attention families, which launch
    none."""
    from repro_torch.models.transformer import layer_schedule

    kind, kernel = {"ssm": ("rwkv", "rwkv6_recurrence"),
                    "hybrid": ("lru", "rglru_scan")}.get(cfg.family,
                                                         (None, None))
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
# phases 13-14: tensor-parallel serving through the switch collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPSizes:
    """A tensor-parallel serve phase's mesh and traffic."""
    tp: int                    # LocalMesh({"tp": tp})
    batch: int                 # batched prefill and decode batch
    prompt: int                # prefill tokens per sequence
    steps: int                 # greedy decode ticks after the prefill
    slots: int                 # ServeEngine slots
    requests: tuple            # ServeEngine: (prompt tokens, new tokens)
    rounds: int = 2            # turns of the five modes (timed, checked)
    f32_layers: Optional[int] = None  # the f32 semantics check's depth
    layers: Optional[int] = None      # a depth cut (None: the config's)


# 16 requests, prompts 64-512 and 32 new tokens each, over 8 slots: the
# 512-token prompt takes one slot for 544 ticks while the other seven
# slots serve the fifteen shorter ones
TP_REQUESTS = tuple((p, 32) for p in (512, 64, 96, 128, 64, 96, 128, 160,
                                      64, 96, 128, 160, 192, 224, 256,
                                      288))
# qwen3-8b on 8 ranks: a batched 8 x 512 prefill, 32 greedy ticks at
# batch 8, two turns of the five modes, then the engine; 18 of its 36
# layers at full width since the run went over its ceiling on slow hosts
# with the GSPMD slice's own cut in place (PERF.md §4, §6)
SERVE_TP_DENSE = TPSizes(tp=8, batch=8, prompt=512, steps=32, slots=8,
                         requests=TP_REQUESTS, layers=18)
# qwen2-moe-a2.7b on 4 ranks (tp=8 does not divide its 60 experts): a
# 4 x 64 prefill, which a MoE stack runs as 64 decode ticks (the
# reference's prefill; 256 until the train phase needed the time), so
# one turn of the five modes; the f32 semantics check on a 4-layer f32
# model of the same widths; 16 of its 24 layers at full width since the
# examples phase joined the run (PERF.md §4)
SERVE_TP_MOE = TPSizes(tp=4, batch=4, prompt=64, steps=32, slots=8,
                       requests=TP_REQUESTS, rounds=1, f32_layers=4,
                       layers=16)
# the same phases at sizes a CPU runs in seconds (a rehearsal only)
SERVE_TP_SMOKE = TPSizes(tp=2, batch=2, prompt=6, steps=3, slots=2,
                         requests=((5, 3), (3, 4), (4, 2)), f32_layers=2)
TP_MODES = ("compiled", "compiled_plain", "direct", "xla", "unsharded")


def tp_launches(programs, n: int) -> dict:
    """``fused_combine`` launches (all three forms) of one run of the
    ``(name, program, calls)`` list on a ring of ``n`` ranks
    (:func:`expected_launches` of each program): n-1 ``fused_hop`` and
    one ``fused_gather`` per bandwidth ring all-reduce, n-1 elementwise
    ``fused_combine`` per latency ring and per fused
    ``allreduce+alltoall`` stage; an all-to-all is data movement only."""
    from repro_torch.mesh import LocalMesh

    mesh = LocalMesh({"tp": n}, device="meta")
    out = {"fused_combine": 0, "fused_hop": 0, "fused_gather": 0}
    for _, prog, calls in programs:
        per = expected_launches(prog, mesh)
        for k in out:
            out[k] += calls * per[k]
    return out


class RoutingLog:
    """Within the block, every MoE routing decision (``moe.top_k``'s
    expert indices, ``[*rank, G, Ng, k]``) in call order."""

    def __enter__(self):
        from repro_torch.models import moe

        self.mod, self.orig, self.calls = moe, moe.top_k, []

        def top_k(x, k):
            vals, idx = self.orig(x, k)
            self.calls.append(idx)
            return vals, idx
        moe.top_k = top_k
        return self

    def __exit__(self, *exc):
        self.mod.top_k = self.orig
        return False


class RoutingReplay:
    """Within the block, ``moe.top_k`` returns the expert indices of a
    recorded run (:class:`RoutingLog`) in call order, with this run's own
    probabilities at them: two runs of one model then compute the same
    function even where their routers sit one rounding apart near a tie
    (top-k is discontinuous, and a random bf16 router ties often).
    ``apart`` counts the rows whose own top-k chose other experts, of
    ``rows`` routing decisions; the calls must match the record's."""

    def __init__(self, routes: list):
        self.routes = routes

    def __enter__(self):
        from repro_torch.models import moe

        self.mod, self.orig = moe, moe.top_k
        self.calls, self.apart, self.rows = 0, 0, 0

        def top_k(x, k):
            own = self.orig(x, k)[1]
            idx = self.routes[self.calls].reshape(own.shape)
            self.calls += 1
            self.apart = self.apart + (own != idx).any(-1).sum()
            self.rows += own[..., 0].numel()
            return x.gather(-1, idx), idx
        moe.top_k = top_k
        return self

    def __exit__(self, *exc):
        self.mod.top_k = self.orig
        self.apart = int(self.apart)
        if exc[0] is None:
            check(self.calls == len(self.routes), f"routing replay: "
                  f"{self.calls} calls of {len(self.routes)} recorded")
        return False


def hold_routed(want: torch.Tensor, got: torch.Tensor, want_idx: list,
                got_idx: list, rel: float) -> tuple[float, int, int]:
    """One decode step of a MoE model from the same cache: the rows whose
    routing agrees in every layer (every rank of ``got`` picking the
    experts ``want`` picks) hold their logits within ``rel`` of the row's
    largest |logit|.  A row routed elsewhere computes another function
    (top-k is discontinuous: a probability one rounding from a tie flips
    it).  Returns (worst error over the bound, rows compared, rows)."""
    agree = torch.ones(want.shape[0], dtype=torch.bool, device=want.device)
    for w, g in zip(want_idx, got_idx):
        same = (g == w).all(-1)                    # [*rank, G, Ng]
        agree &= same.reshape(-1, same.shape[-1]).all(0)
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    tol = rel * want.float().abs().amax(-1)
    err = (got.float() - want.float()).abs().amax(-1) / tol
    worst = err[agree].max().item() if bool(agree.any()) else 0.0
    return worst, int(agree.sum()), agree.numel()


def _add_counts(a: dict, b: dict, times: int = 1) -> dict:
    return {k: a.get(k, 0) + times * b.get(k, 0) for k in set(a) | set(b)}


def routed_steps(sc, split, ref: dict, feed: list, t: int, rel: float
                 ) -> dict:
    """Every decode step of ``ref`` (a run of the unsharded model with
    its caches before each step and its routing, :class:`RoutingLog`)
    run again tensor-parallel, compiled, from the same cache, held by
    :func:`hold_routed`: the rows routed alike within ``rel``."""
    dec = sc.decode_fn(split, None)
    per = len(ref["routes"]) // (t + len(feed))
    worst, compared, rows = 0.0, 0, 0
    for j, tok in enumerate(feed):
        cache = sc.shard_cache(ref["caches"][j])
        with RoutingLog() as log:
            lg, _ = dec(split, tok, cache, t + j)
        k = (t + j) * per
        w, c, n = hold_routed(ref["logits"][j + 1], lg,
                              ref["routes"][k:k + per], log.calls, rel)
        worst, compared, rows = max(worst, w), compared + c, rows + n
    check(worst <= 1, f"logits of rows routed alike differ by "
          f"{worst:.3g} x the bound ({rel})")
    return {"logit_err_over_bound": worst, "rows_compared": compared,
            "rows": rows}


def rank_spread(sc, split, cache, feed: list, t: int, want: list) -> dict:
    """Every rank's logits of the compiled decode ticks from ``cache``
    (the cache after the prefill; ``decode_step`` under the hook in the
    mesh, with no ``rank0``): each rank within ``BF16_REL`` of rank 0's
    row maximum of rank 0's logits, and rank 0's within the same of
    ``want`` (these ticks through ``decode_fn``).  A rank that routed a
    token apart, or gathered another token's expert output, would hold
    another hidden state."""
    from repro_torch.models import decode as D
    from repro_torch.models import parallel as TPH

    worst, vs_fn, bitwise = 0.0, 0.0, True
    with sc.mesh, TPH.tensor_parallel(sc.hook("compiled")), torch.no_grad():
        for i, tok in enumerate(feed):
            lg, cache = D.decode_step(split, sc.cfg_local, tok, cache, t + i)
            lg = lg.float()
            tol = BF16_REL * lg[0].abs().amax(-1)
            worst = max(worst, ((lg[1:] - lg[0]).abs().amax(-1)
                                / tol).max().item())
            vs_fn = max(vs_fn, ((lg[0] - want[i].float()).abs().amax(-1)
                                / tol).max().item())
            bitwise &= bool((lg == lg[:1]).all())
    check(worst <= 1, f"the ranks' logits differ by {worst:.3g} x the "
          f"bound ({BF16_REL})")
    check(vs_fn <= 1, f"rank 0's logits differ from decode_fn's by "
          f"{vs_fn:.3g} x the bound ({BF16_REL})")
    return {"rank_vs_rank0_err_over_bound": worst, "ranks_bitwise": bitwise,
            "rank0_vs_decode_fn_err_over_bound": vs_fn, "ranks": lg.shape[0],
            "ticks": len(feed)}


def unsharded_run(model, params, toks, steps: int, dev, dtype) -> dict:
    """Prefill and ``steps`` greedy ticks of the unsharded model, its
    routing recorded and its cache kept before every tick."""
    from repro_torch import tree

    b, t = toks.shape
    cache = model.init_cache(b, t + steps + 1, dtype, device=dev)
    out = {"logits": [], "caches": [], "tokens": []}
    with RoutingLog() as log:
        lg, cache = model.prefill(params, toks, cache)
        out["logits"].append(lg)
        for i in range(steps):
            tok = lg.argmax(-1)
            out["tokens"].append(tok)
            out["caches"].append(tree.tree_map(torch.clone, cache))
            lg, cache = model.decode_step(params, tok, cache, t + i)
            out["logits"].append(lg)
    out["routes"] = log.calls
    return out


def tp_f32_check(cfg, seed: int, sizes: TPSizes, dev) -> dict:
    """The semantics check of a MoE stack: ``sizes.f32_layers`` layers of
    the same widths with f32 weights (in bf16 a random model's router
    probabilities sit within a rounding of a tie often enough that most
    rows route differently somewhere in 24 layers), served
    tensor-parallel with compiled programs and kernels against the
    unsharded model: the prefill's logits (rows routed alike over the
    whole prompt) and every decode step from the unsharded cache
    (:func:`routed_steps`) within ``F32_REL``; at least 3/4 of the rows
    compared."""
    from repro_torch.models import Model
    from repro_torch.serve.collectives import (ServeCollectives,
                                               SwitchProgramCache)

    cfg = dataclasses.replace(cfg, n_layers=sizes.f32_layers,
                              param_dtype="float32")
    model = Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen, device=dev)
    b, t = sizes.batch, sizes.prompt
    toks = torch.randint(0, cfg.vocab, (b, t), device=dev, generator=gen)
    sc = ServeCollectives(cfg, sizes.tp, device=dev,
                          cache=SwitchProgramCache())
    split = sc.shard_params(params)
    ref = unsharded_run(model, params, toks, sizes.steps, dev,
                        torch.float32)
    per = len(ref["routes"]) // (t + sizes.steps)
    cache = sc.shard_cache(model.init_cache(b, t + sizes.steps + 1,
                                            torch.float32, device=dev))
    with RoutingLog() as log:
        lg, _ = sc.prefill_fn()(split, toks, cache)
    pre = hold_routed(ref["logits"][0], lg, ref["routes"][:t * per],
                      log.calls, F32_REL)
    check(pre[0] <= 1, f"f32 prefill: logits of rows routed alike differ "
          f"by {pre[0]:.3g} x the bound ({F32_REL})")
    steps = routed_steps(sc, split, ref, ref["tokens"], t, F32_REL)
    compared = pre[1] + steps["rows_compared"]
    rows = pre[2] + steps["rows"]
    check(4 * compared >= 3 * rows, f"f32: only {compared} of {rows} rows "
          "routed alike")
    return {"layers": cfg.n_layers, "rel": F32_REL,
            "prefill_err_over_bound": pre[0],
            "decode_err_over_bound": steps["logit_err_over_bound"],
            "rows_compared": compared, "rows": rows}


def tp_serve_path(cfg, seed: int, sizes: TPSizes, *, device="cuda",
                  expect_kernels: bool = True, phase: str = "serve_tp"
                  ) -> list[dict]:
    """A dense or MoE model served tensor-parallel on ``LocalMesh({"tp":
    sizes.tp})`` at full width (seeded random bf16 weights made on the
    device):

      * the params split once (``ServeCollectives.shard_params``);
      * a batched prefill of ``batch`` x ``prompt`` tokens and ``steps``
        greedy decode ticks in each of five modes, in turns (``rounds``
        turns): compiled switch programs with kernels, compiled with
        ``use_kernels=False``, direct acis rings, the plain (xla)
        reduction, and the unsharded model with no hook; every mode fed
        the first one's tokens;
      * checks: compiled with kernels bitwise equal to compiled without
        (logits and cache); a dense stack's compiled bitwise equal to
        direct, and every mode's logits within ``BF16_REL`` of the
        unsharded path's (:func:`hold_logits`); ``fused_combine`` and
        ``fused_hop`` launched exactly as ``prefill_programs`` /
        ``decode_programs`` predict with kernels (:func:`tp_launches`)
        and never without, ``fused_gather`` as they predict in both
        compiled modes and never in the xla and unsharded ones; a MoE
        tick holds ``serve_moe_alltoall`` and
        ``serve_moe_combine``, the combine one ``allreduce+alltoall``
        stage;
      * a MoE stack: the direct, xla and unsharded runs replay the
        compiled run's expert choices (:class:`RoutingReplay`; top-k is
        discontinuous, and a random bf16 router sits one rounding from a
        tie often enough that one flip in 24 layers sends most rows down
        another path), so every row of every step is held, and the rows
        whose own routing chose other experts are counted; compiled
        differs from direct in bits there (the fused combine folds the
        shared experts' partials in the reference's latency order, the
        direct ring in its bandwidth order); then :func:`tp_f32_check`
        holds the natural routing;
      * every rank's logits of the compiled decode ticks
        (:func:`rank_spread`);
      * a profile of one compiled decode tick;
      * ``ServeEngine(slots, collectives=)`` over ``requests``: every
        request completes in full, its launches as the ticks' programs
        predict."""
    from repro_torch import tree
    from repro_torch.core.api import CollectiveConfig
    from repro_torch.models import Model
    from repro_torch.obs import metrics
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.collectives import (ServeCollectives,
                                               SwitchProgramCache)

    import numpy as np

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    config_layers = cfg.n_layers
    if sizes.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=sizes.layers)
    model = Model(cfg)
    n_params = sum(x.numel() for x in tree.tree_leaves(model.param_shapes()))
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    cache_pool = SwitchProgramCache()
    sc = {uk: ServeCollectives(cfg, sizes.tp, cache=cache_pool, device=dev,
                               config=CollectiveConfig(backend="acis",
                                                       use_kernels=uk))
          for uk in (True, False)}
    t0 = time.perf_counter()
    split = sc[True].shard_params(params)
    _sync(dev)
    shard_s = time.perf_counter() - t0
    b, t = sizes.batch, sizes.prompt
    toks = torch.randint(0, cfg.vocab, (b, t), device=dev, generator=gen)
    seq = t + sizes.steps + 1
    moe = cfg.family == "moe"
    t0 = time.perf_counter()
    dec_progs = sc[True].decode_programs(b)
    pre_progs = [(n, p, c * t) for n, p, c in dec_progs] if moe \
        else sc[True].prefill_programs(b, t)
    sc[False].decode_programs(b)
    if not moe:
        sc[False].prefill_programs(b, t)
    compile_s = time.perf_counter() - t0
    names = {n: p for n, p, _ in dec_progs}
    if moe:
        check({"serve_moe_alltoall", "serve_moe_combine"} <= set(names),
              f"a MoE tick runs {sorted(names)}")
        check(names["serve_moe_combine"].stage_kinds()
              == ["allreduce+alltoall"], "the MoE combine is not one "
              "allreduce+alltoall stage")
    want = _add_counts(tp_launches(pre_progs, sizes.tp),
                       tp_launches(dec_progs, sizes.tp), sizes.steps)

    def fns(mode):
        """(prefill, decode, params, cache) of one mode."""
        if mode == "unsharded":
            return (model.prefill, model.decode_step, params,
                    model.init_cache(b, seq, device=dev))
        s = sc[mode != "compiled_plain"]
        m = "compiled" if mode.startswith("compiled") else mode
        cache = s.shard_cache(model.init_cache(b, seq, device=dev))
        return (s.prefill_fn(mode=m), s.decode_fn(split, cache, mode=m),
                split, cache)

    def run(mode, feed=None, keep=False):
        """Prefill and ``steps`` ticks of one mode (``keep``: a copy of
        the cache after the prefill, outside the timed spans)."""
        pre, dec, p, cache = fns(mode)
        _sync(dev)
        t0 = time.perf_counter()
        lg, cache = pre(p, toks, cache)
        _sync(dev)
        out = {"prefill_ms": (time.perf_counter() - t0) * 1e3,
               "step_ms": [], "logits": [lg], "tokens": []}
        if keep:
            out["prefilled"] = tree.tree_map(torch.clone, cache)
        for i in range(sizes.steps):
            tok = lg.argmax(-1) if feed is None else feed[i]
            out["tokens"].append(tok)
            _sync(dev)
            t0 = time.perf_counter()
            lg, cache = dec(p, tok, cache, t + i)
            _sync(dev)
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["logits"].append(lg)
        out["cache"] = cache
        return out

    launches = dict.fromkeys(kernel_modules(), 0)
    rounds, held, feed, routes, apart = [], {}, None, None, {}
    direct_bitwise, spread = True, None
    for rnd in range(sizes.rounds):      # odd rounds in reverse order
        res = {}
        for mode in (TP_MODES if rnd % 2 == 0 else TP_MODES[::-1]):
            reset_counts()
            first = rnd == 0 and mode == "compiled"
            if moe and first:
                # the compiled run's expert choices, which the direct,
                # xla and unsharded runs replay: every mode then computes
                # one function, held on every row
                with RoutingLog() as log:
                    res[mode] = run(mode, feed, keep=True)
                routes = log.calls
            elif moe and mode in ("direct", "xla", "unsharded"):
                with RoutingReplay(routes) as rp:
                    res[mode] = run(mode, feed)
                apart.setdefault(mode, (rp.apart, rp.rows))
            else:
                res[mode] = run(mode, feed, keep=first)
            got = read_counts()
            need = want if mode == "compiled" and expect_kernels else {}
            for k in ("fused_combine", "fused_hop"):
                check(got[k] == need.get(k, 0),
                      f"{phase} {mode}: {k} launched {got[k]} times, the "
                      f"programs predict {need.get(k, 0)}")
            # the gather kernel takes the compiled programs' all-gathers
            # with use_kernels off too (the direct rings' are not
            # predicted by a plan)
            if expect_kernels and mode in ("compiled", "compiled_plain",
                                           "xla", "unsharded"):
                k = "fused_gather"
                need = want[k] if mode.startswith("compiled") else 0
                check(got[k] == need, f"{phase} {mode}: {k} launched "
                      f"{got[k]} times, the programs predict {need}")
            launches = _add_counts(launches, got)
            if feed is None:
                feed = res[mode]["tokens"]
        ck, cp, cd = res["compiled"], res["compiled_plain"], res["direct"]
        for a, c in zip(ck["logits"], cp["logits"]):
            check(torch.equal(a, c), f"{phase}: compiled logits differ "
                  "with and without kernels")
        for a, c in zip(tree.tree_leaves(ck["cache"]),
                        tree.tree_leaves(cp["cache"])):
            check(torch.equal(a, c), f"{phase}: compiled caches differ "
                  "with and without kernels")
        direct_bitwise &= all(
            torch.equal(a, c) for a, c in zip(ck["logits"], cd["logits"])) \
            and all(torch.equal(a, c) for a, c in zip(
                tree.tree_leaves(ck["cache"]), tree.tree_leaves(cd["cache"])))
        if not moe:
            check(direct_bitwise, f"{phase}: compiled and direct differ")
        for mode in TP_MODES[:-1]:
            held[mode] = hold_logits(res["unsharded"]["logits"],
                                     res[mode]["logits"], BF16_REL)
        if rnd == 0:
            reset_counts()
            spread = rank_spread(sc[True], split, ck["prefilled"], feed, t,
                                 ck["logits"][1:])
            launches = _add_counts(launches, read_counts())
        rounds.append({m: (r["prefill_ms"], r["step_ms"])
                       for m, r in res.items()})
        del res, ck, cp, cd
    peak_mem = torch.cuda.max_memory_allocated() if cuda else None
    med = statistics.median
    record = {
        "phase": phase, "program": "prefill_decode", "model": cfg.name,
        "family": cfg.family, "layers": cfg.n_layers,
        "config_layers": config_layers, "params": n_params,
        "param_bytes": sum(x.numel() * x.element_size()
                           for x in tree.tree_leaves(params)),
        "split_param_bytes": sum(
            x.numel() * x.element_size() for x in tree.tree_leaves(split)
            if all(x is not y for y in tree.tree_leaves(params))),
        "tp": sizes.tp, "batch": b, "prompt": t, "steps": sizes.steps,
        "init_s": init_s, "shard_s": shard_s, "compile_s": compile_s,
        "decode_programs": {n: {"calls": c, "stages": p.stage_kinds(),
                                "schedules": [s.schedule
                                              for s in p.stages]}
                            for n, p, c in dec_progs},
        "prefill_ms": {m: [r[m][0] for r in rounds] for m in TP_MODES},
        "decode_ms_per_tick": {m: med([x for r in rounds for x in r[m][1]])
                               for m in TP_MODES},
        "bf16_rel": BF16_REL,
        "vs_unsharded": {m: h["logit_err_over_bound"]
                         for m, h in held.items()},
        "vs_unsharded_rule": "free-running from one prompt, every row of "
        "every step" + ("; the direct, xla and unsharded runs replay the "
        "compiled run's expert choices" if moe else ""),
        "routing_rows_apart": {m: list(v) for m, v in apart.items()},
        "rank_spread": spread,
        "compiled_bitwise_to_plain": True,
        "compiled_bitwise_to_direct": direct_bitwise,
        "launches_per_run_predicted": want,
        "decode_comm_time_s": sc[True].decode_comm_time(b),
        "prefill_comm_time_s": sc[True].prefill_comm_time(b, t),
        "cost_model": COST_MODEL_NOTE,
        "max_memory_allocated": peak_mem,
    }
    if cuda:
        pre, dec, p, cache = fns("compiled")
        lg, cache = pre(p, toks, cache)
        reset_counts()
        record["profile"] = {"decode_tick": device_profile(
            lambda: dec(p, lg.argmax(-1), cache, t), RING_OPS)}
        launches = _add_counts(launches, read_counts())
        del cache

    # the engine on the compiled transport
    rng = np.random.default_rng(seed)
    reqs = [(i, rng.integers(0, cfg.vocab, p).astype(np.int32), n)
            for i, (p, n) in enumerate(sizes.requests)]
    max_seq = max(p + n for p, n in sizes.requests) + 2
    rec = metrics.Recorder()
    eng = ServeEngine(model, split, slots=sizes.slots, max_seq=max_seq,
                      recorder=rec, collectives=sc[True])
    est0 = eng.tick_time_estimate()
    for rid, prompt, n_new in reqs:
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n_new))
    reset_counts()
    _sync(dev)
    t0 = time.perf_counter()
    done = eng.run_to_completion()
    _sync(dev)
    wall = time.perf_counter() - t0
    got = read_counts()
    tick = tp_launches(sc[True].decode_programs(sizes.slots), sizes.tp)
    if expect_kernels:
        for k, v in tick.items():
            check(got[k] == eng.ticks * v, f"{phase} engine: {k} launched "
                  f"{got[k]} times, {eng.ticks} ticks need {v} each")
    check([c.rid for c in done] == [r[0] for r in reqs]
          and [len(c.tokens) for c in done] == [n for _, _, n in reqs],
          f"{phase}: the engine did not complete every request in full")
    ticks = sorted(eng._tick_times)
    n_tok = sum(len(c.tokens) for c in done)
    eng_rec = {
        "phase": phase, "program": "engine", "model": cfg.name,
        "tp": sizes.tp, "slots": sizes.slots,
        "requests": [list(r) for r in sizes.requests], "ticks": eng.ticks,
        "wall_s": wall, "generated_tokens": n_tok,
        "tokens_per_s": n_tok / wall,
        "tick_p50_ms": ticks[len(ticks) // 2] * 1e3,
        "tick_p99_ms": ticks[min(len(ticks) - 1,
                                 int(len(ticks) * 0.99))] * 1e3,
        "tick_estimate_before_first_tick_s": est0,
        "cost_model": COST_MODEL_NOTE,
        "program_cache": cache_pool.stats(),
        "counters": {k: rec.counter(k) for k in (
            "serve.ticks", "serve.admitted", "serve.retired",
            "serve.host_sync")},
        "launches": got, "launches_per_tick": tick,
    }
    del eng, split, params
    if cuda:
        torch.cuda.empty_cache()
    if moe and sizes.f32_layers:
        reset_counts()
        record["f32_check"] = tp_f32_check(cfg, seed, sizes, dev)
        launches = _add_counts(launches, read_counts())
    record["launches"] = launches
    return [record, eng_rec]


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
            # a masked and an unmasked sync with kernels, and the plain
            # masked sync's gathers
            check_launches(launches, {
                k: per_sync[k] + per_plain_sync[k] + (
                    per_sync[k] if k == "fused_gather" else 0)
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


# ---------------------------------------------------------------------------
# the train phase: acis-100m trained through the switch gradient sync
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainSizes:
    """The train phase's sizes: ``train_e2e``'s traffic (global batch x
    seq, ``BigramStream(seed=7)``, AdamW with ``warmup_cosine(lr, warmup,
    e2e_steps)``), ``steps`` per backend of the kernels-vs-plain check,
    the end-to-end run's length, the checkpoint its resume starts from
    and the descent bar of a run without the example's (which fixes its
    own optimizer and bar, ``examples/torch_train_e2e.py``: ``lr`` 3e-4,
    ``warmup`` 20, 0.5 from 200 steps and 0.1 below)."""
    batch: int
    seq: int
    steps: int
    e2e_steps: int
    ckpt_at: int
    log_every: int
    lr: float
    warmup: int
    bar: float


TRAIN = TrainSizes(batch=8, seq=256, steps=3, e2e_steps=200, ckpt_at=100,
                   log_every=10, lr=3e-4, warmup=20, bar=0.5)
# the example's 30 steps of 8 x 32 pass its bar of 0.1 (a checkpoint every
# 7 steps, the last three kept: 14, 21, 28)
TRAIN_SMOKE = TrainSizes(batch=8, seq=32, steps=2, e2e_steps=30, ckpt_at=14,
                         log_every=2, lr=1e-2, warmup=2, bar=0.1)
TRAIN_BACKENDS = (("acis", None, {"data": 8}),
                  ("acis_compressed", "int8", {"data": 8}),
                  ("acis_compressed", "int8_hopquant", {"data": 8}),
                  ("acis_compressed", "topk", {"data": 8}),
                  ("acis_hierarchical", None, {"pod": 2, "data": 4}))


def train_batch(model, stream, step: int, dev) -> dict:
    """``stream``'s batch at ``step``; for an encdec or vlm model also its
    stub context, ``synthetic_context`` at the step made into the
    served bf16 (:meth:`Model.context_inputs`) on ``dev``."""
    from repro_torch.data.pipeline import synthetic_context

    batch = stream.batch(step)
    spec = model.context_inputs(len(batch["tokens"]))
    if spec is not None:
        (b, t, d), dt = spec
        batch["context"] = torch.from_numpy(
            synthetic_context(step, b, t, d)).to(dev, dt)
    return batch


def _tree_equal(a, b) -> bool:
    from repro_torch import tree
    la, lb = tree.tree_leaves(a), tree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _clone_tree(t):
    from repro_torch import tree
    return tree.tree_map(lambda x: x.clone(), t)


def _to_device(t, dev):
    """Every leaf of ``t`` (None stays None) on ``dev``."""
    from repro_torch import tree
    return None if t is None else tree.tree_map(lambda x: x.to(dev), t)


def _fresh_peak(dev) -> Optional[int]:
    """Release the allocator's cache and restart the peak count; returns
    the bytes still allocated (None off the card)."""
    if dev.type != "cuda":
        return None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def rank_agreement(synced, grads, residual, nd: int, exact: bool,
                   compressor) -> float:
    """The largest difference of any rank's synced gradients from rank
    0's.  ``exact`` (every all-reduce stage a bandwidth ring, whose
    all-gather hands out one copy, and no ``topk``): 0, bit for bit.
    Else within rounding, per lane: a latency-optimal ring folds in a
    rank-relative order (ROADMAP.md R4), each of its n-1 adds rounding by
    half an ulp of a partial sum bounded by ``m`` (the sum over the ranks
    of ``|g|``, plus ``|r|`` under EF), so the mean moves by ``(n-1)/2 ·
    eps · m / n``, plus one rounding of the output; the sparse ``topk``
    ring adds in a rank-relative order (ROADMAP.md R5), as in the
    compressed phase (``eps·|out| + 2^-23·m``)."""
    from repro_torch import tree
    worst = 0.0
    res = tree.tree_leaves(residual) if residual is not None else None
    for i, (o, g) in enumerate(zip(tree.tree_leaves(synced),
                                   tree.tree_leaves(grads))):
        of = o.flatten(0, nd - 1)
        n = of.shape[0]
        d = (of.float() - of[0:1].float()).abs()
        if exact:
            check(bool((of == of[0:1]).all()),
                  f"ranks' synced gradients differ by {d.max().item()}")
        else:
            eps = 2.0 ** -8 if o.dtype == torch.bfloat16 else 2.0 ** -23
            m = g.float().abs().flatten(0, nd - 1).sum(0)
            if res is not None:
                m = m + res[i].abs().flatten(0, nd - 1).sum(0)
            omax = of.float().abs().max(0).values
            bound = eps * omax + (2.0 ** -23 * m if compressor == "topk"
                                  else (n - 1) / 2 * eps * m / n)
            check(bool((d <= bound).all()),
                  f"ranks' synced gradients differ by {d.max().item()}, "
                  "beyond the fold's rounding")
        worst = max(worst, d.max().item())
    return worst


def train_sync_check(cfg, seed: int, sizes: TrainSizes, backend: str,
                     compressor, axes: dict, dev, *,
                     expect_kernels: bool = True) -> dict:
    """``sizes.steps`` train steps of ``cfg`` on ``LocalMesh(axes)``:
    each step's per-rank gradients computed once, then synced and applied
    twice from one seeded state, kernels on and ``use_kernels=False`` in
    turns; the synced gradients, residuals and updated params and
    optimizer state bitwise equal; every rank holding the same synced
    gradients; each kernel launched as the compiled plan says x steps;
    the peak device memory under ``PEAK_LIMIT`` (:func:`check_peak`)."""
    from repro_torch.core import make_engine
    from repro_torch.data.pipeline import BigramStream, DataConfig
    from repro_torch.mesh import LocalMesh
    from repro_torch.models import Model
    from repro_torch.train import optimizer as O
    from repro_torch.train import step as S

    sync_dev = _dev_sync(dev)
    mesh = LocalMesh(axes, device=dev)
    outer = "pod" if "pod" in axes else None
    kw = {} if compressor is None else {"compressor": compressor}
    eng_k = make_engine(backend, outer_axis=outer, **kw)
    eng_p = make_engine(backend, outer_axis=outer, use_kernels=False, **kw)
    model = Model(cfg)
    opt = O.adamw(O.warmup_cosine(sizes.lr, sizes.warmup, sizes.e2e_steps))
    at_start = _fresh_peak(dev)
    st_k = S.init_state(model, opt, torch.Generator(device=dev)
                        .manual_seed(seed), eng_k, mesh=mesh, arenas=True)
    st_p = S.TrainState(_clone_tree(st_k.params), _clone_tree(st_k.opt),
                        st_k.step.clone(), _clone_tree(st_k.ef_residual),
                        eng_p.init_arenas(S.grads_like(st_k.params, mesh),
                                          mesh=mesh))
    compiled = eng_k.last_sync_program()
    per_sync = expected_launches(compiled, mesh)
    exact = compressor != "topk" and all(
        st.schedule != "latency" for st in compiled.stages)
    stream = BigramStream(DataConfig(vocab=cfg.vocab, seq_len=sizes.seq,
                                     global_batch=sizes.batch, seed=7))
    reset_counts()
    t_g, t_k, t_p, spread = [], [], [], 0.0
    for step in range(sizes.steps):
        batch = train_batch(model, stream, step, dev)
        sync_dev()
        t0 = time.perf_counter()
        grads, metrics = S.local_grads(model, st_k, batch, mesh)
        sync_dev()
        t_g.append((time.perf_counter() - t0) * 1e3)

        # each path's old state is dropped once that path has run, and
        # the first path's new EF residual waits on the host while the
        # second runs, so no more than two residuals share the card
        # (whisper's [8, 304M] f32 residuals are 9.7 GB each)
        old = {"k": st_k, "p": st_p}
        st_k = st_p = None

        def run(which, eng):
            st = old.pop(which)
            sync_dev()
            t0 = time.perf_counter()
            out = S.sync_and_update(eng, opt, st, grads, metrics, mesh)
            sync_dev()
            dt = (time.perf_counter() - t0) * 1e3
            if which == "k":
                agree.append(rank_agreement(out[2], grads, st.ef_residual,
                                            mesh.rank_ndim, exact,
                                            compressor))
            if old:                         # the first path of the step
                out[0].ef_residual = _to_device(out[0].ef_residual, "cpu")
            return out, dt

        agree: list = []
        ((new_k, m_k, syn_k), dt_k), ((new_p, m_p, syn_p), dt_p) = \
            in_turns(step, lambda: run("k", eng_k), lambda: run("p", eng_p))
        spread = max([spread] + agree)
        new_k.ef_residual = _to_device(new_k.ef_residual, dev)
        new_p.ef_residual = _to_device(new_p.ef_residual, dev)
        t_k.append(dt_k)
        t_p.append(dt_p)
        what = f"train {backend}/{compressor} step {step}"
        check(_tree_equal(syn_k, syn_p), f"{what}: synced gradients differ "
              "from use_kernels=False")
        check(_tree_equal(new_k.ef_residual, new_p.ef_residual),
              f"{what}: residuals differ from use_kernels=False")
        check(_tree_equal(new_k.params, new_p.params)
              and _tree_equal(new_k.opt, new_p.opt),
              f"{what}: updated params or optimizer state differ")
        check(all(math.isfinite(float(v)) for v in m_k.values()),
              f"{what}: non-finite metrics {m_k}")
        st_k, st_p = new_k, new_p
        del grads, syn_k, syn_p, new_k, new_p
    launches = read_counts()
    if expect_kernels:
        check_launches(launches, with_plain_gathers(per_sync), sizes.steps)
        check(any(per_sync.values()),
              f"the {backend} sync runs none of the kernels")
    return {"phase": "train", "program": "sync_check", "backend": backend,
            "compressor": compressor, "mesh": dict(axes),
            "model": cfg.name, "steps": sizes.steps,
            "global_batch": sizes.batch, "seq": sizes.seq,
            "launches_per_sync": per_sync, "launches": launches,
            "grads_ms": t_g, "sync_update_ms_kernels": t_k,
            "sync_update_ms_plain": t_p,
            "bitwise_equal_to_plain": True,
            "ranks_bitwise": exact, "max_rank_spread": spread,
            "last_metrics": {k: float(v) for k, v in m_k.items()},
            "allocated_at_start": at_start,
            "max_memory_allocated": check_peak(
                dev, f"train {backend}/{compressor} step check")}


def _timed_step(step_fn, sync_dev, times: list):
    def run(state, batch):
        sync_dev()
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        sync_dev()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    run.mesh = step_fn.mesh
    return run


def train_profile(model, opt, eng, state, batch, mesh) -> dict:
    """One more step (its result dropped) under ``torch.profiler``: the
    whole step's device time, busy share and top device ops, then its
    forward + backward, sync and optimizer each in a window of its own."""
    from repro_torch.train import step as S

    grads, metrics = S.local_grads(model, state, batch, mesh)
    synced, _, *_ = eng.gradient_sync(grads, state.ef_residual,
                                      arenas=state.sync_arenas, mesh=mesh)
    g0 = S.rank0(synced, mesh.rank_ndim)
    parts = {
        "step": device_profile(lambda: S.sync_and_update(
            eng, opt, state, *S.local_grads(model, state, batch, mesh),
            mesh), RING_OPS),
        "forward_backward": device_profile(
            lambda: S.local_grads(model, state, batch, mesh)),
        "sync": device_profile(lambda: eng.gradient_sync(
            grads, state.ef_residual, arenas=state.sync_arenas, mesh=mesh),
            RING_OPS),
        "optimizer": device_profile(lambda: opt.update(
            g0, state.opt, state.params, state.step)),
    }
    for k in ("forward_backward", "sync", "optimizer"):
        parts[k].pop("top", None)
    return parts


def train_e2e(cfg, seed: int, sizes: TrainSizes, dev, *,
              expect_kernels: bool = True) -> dict:
    """``examples/torch_train_e2e.py``'s ``main`` with its default
    backend (``acis_compressed``, int8, on ``LocalMesh({"data": 4})``),
    ``sizes.e2e_steps`` steps of ``sizes.batch`` x ``sizes.seq`` and a
    checkpoint every quarter; its own assert holds the nll's fall (0.5
    from 200 steps).  A fresh run from the twin's ``setup``, restored
    from the step-``sizes.ckpt_at`` checkpoint and run to the end, must
    match the straight run's params, optimizer state and EF residual bit
    for bit (deterministic algorithms on for both runs).  The twin seeds
    its params with 0, as the reference's example does; ``seed`` is
    unused."""
    import tempfile
    import warnings

    from repro_torch import obs, tree
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.train.loop import LoopConfig, TrainLoop

    del seed
    cuda = dev.type == "cuda"
    twin = load_example("train_e2e")
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_ckpt_") \
                as d, warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            argv = ["--steps", str(sizes.e2e_steps), "--batch",
                    str(sizes.batch), "--seq", str(sizes.seq),
                    "--ckpt-dir", d]
            reset_counts()
            t0 = time.perf_counter()
            with obs.recording(spans=True) as rec:
                out = twin.main(argv, device=dev, cfg=cfg)
            t_run = time.perf_counter() - t0
            run, straight = out["run"], out["state"]
            check(run.engine.config.use_kernels, "use_kernels is off by "
                  "default")
            ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                             for r, _, fs in os.walk(d) for f in fs)
            # a fresh process's view: new model, engine and state, restored
            run2 = twin.setup(twin.parse_args(argv), device=dev, cfg=cfg)
            t1 = time.perf_counter()
            st2, at, _ = ckpt.restore(d, run2.state, step=sizes.ckpt_at,
                                      device=run2.mesh.device)
            t_restore = time.perf_counter() - t1
            check(at == int(st2.step) == sizes.ckpt_at,
                  f"restored step {int(st2.step)}, not {sizes.ckpt_at}")
            resumed = TrainLoop(run2.step, run2.stream, LoopConfig(
                total_steps=sizes.e2e_steps,
                log_every=sizes.e2e_steps)).run(st2)
            launches = read_counts()
            nondet = sorted({str(w.message)[:120] for w in caught
                             if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(was)
    for name, a, b in (("params", straight.params, resumed.params),
                       ("optimizer state", straight.opt, resumed.opt),
                       ("EF residual", straight.ef_residual,
                        resumed.ef_residual)):
        check(_tree_equal(a, b), f"train_e2e: the resumed run's {name} "
              "differ from the straight run's")
    check(int(straight.step) == int(resumed.step) == sizes.e2e_steps,
          "train_e2e: wrong final step")
    curve = [[s, nll] for s, nll, _ in out["curve"]]
    check(all(math.isfinite(v) for _, v in curve), "non-finite nll")
    per_sync = expected_launches(out["sync_program"], run.mesh)
    if expect_kernels:
        steps_run = sizes.e2e_steps + (sizes.e2e_steps - sizes.ckpt_at)
        check_launches(launches, per_sync, steps_run)
        for group in EXAMPLE_KERNELS["train_e2e"]:
            check(sum(launches[k] for k in group) > 0,
                  f"train_e2e: none of {group} launched")
    peak = torch.cuda.max_memory_allocated() if cuda else None
    profile = train_profile(run.model, run.optimizer, run.engine, straight,
                            run.stream.batch(sizes.e2e_steps), run.mesh) \
        if cuda else None
    # each step's span: its device time on the card, host time on the CPU
    times = [s.host_ms if s.device_ms is None else s.device_ms
             for s in rec.spans if s.name == "train.step"][:sizes.e2e_steps]
    med = statistics.median(times[1:] or times)
    return {"phase": "train", "program": "train_e2e",
            "example": "examples/torch_train_e2e.py",
            "backend": out["backend"], "compressor": "int8",
            "mesh": out["mesh"], "model": out["model"],
            "params": sum(p.numel() for p in tree.tree_leaves(
                straight.params)),
            "global_batch": sizes.batch, "seq": sizes.seq,
            "steps": sizes.e2e_steps, "ckpt_at": sizes.ckpt_at,
            "curve": curve, "entropy": out["entropy"],
            "nll_first": out["nll_first"], "nll_last": out["nll_last"],
            "step_ms": times, "median_step_ms": med,
            "tokens_per_s": sizes.batch * sizes.seq / (med * 1e-3),
            "example_seconds": out["seconds"],
            "example_tokens_per_s": out["tokens_per_s"],
            "sync_us_model": out["sync_us_model"],
            "arena_bytes": out["arena_bytes"],
            "wire_mb_f32": out["wire_mb_f32"],
            "wire_mb_int16": out["wire_mb_int16"],
            # the straight run's wall minus its steps: the 4 checkpoint
            # saves, the logged metrics' reads and the set-up
            "run_s": t_run,
            "save_log_and_setup_s": t_run - sum(times) / 1e3,
            "restore_s": t_restore, "ckpt_bytes": ckpt_bytes,
            "resumed_bitwise_equal": True,
            "deterministic_algorithms": True,
            "nondeterministic_op_warnings": nondet,
            "launches_per_sync": per_sync, "launches": launches,
            "max_memory_allocated": peak, "profile": profile}


def train_path(cfg, seed: int, sizes: TrainSizes = TRAIN, *,
               device="cuda", expect_kernels: bool = True) -> list[dict]:
    """The train phase: the kernels-vs-plain step check on every backend
    of ``TRAIN_BACKENDS``, then the ``train_e2e`` run."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    recs = [train_sync_check(cfg, seed, sizes, backend, comp, axes, dev,
                             expect_kernels=expect_kernels)
            for backend, comp, axes in TRAIN_BACKENDS]
    recs.append(train_e2e(cfg, seed, sizes, dev,
                          expect_kernels=expect_kernels))
    for r in recs:
        r["phase_seconds"] = time.perf_counter() - t0
    return recs


# ---------------------------------------------------------------------------
# phases 16-19: MLA, encdec and vlm served at full width, whisper trained
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ZooSizes:
    """A serve phase of the MLA, encdec or vlm family: its traffic, the
    depth it runs at (``layers``; None = the config's) and the depth of
    its f32 check (``f32_layers``: a fresh f32 model of that depth, where
    the served depth in f32 would not fit; None = the served weights cast
    to f32 in place), and the engine's mix (none for encdec and vlm,
    whose engine reads no context: ROADMAP.md R6)."""
    batch: int                 # prefill / decode batch
    prompt: int                # prefill tokens (decode ticks, as the
                               # reference prefills these stacks)
    steps: int                 # greedy decode steps after it
    check_steps: int           # decode steps held against Model.forward
    timed_steps: int           # encdec: decode steps timed with the
                               # context re-encoded and encoded once
    layers: Optional[int] = None
    f32_layers: Optional[int] = None
    slots: int = 0
    requests: tuple = ()


# deepseek-v2-236b at full width cut to 1 dense + 3 MoE layers (26.8 GB
# of bf16 weights, 1.3e10 parameters; the config's 60 layers are about
# 472 GB), its f32 check on a fresh 1 dense + 1 MoE model (21.4 GB; the
# four layers would be 53.6 GB in f32)
SERVE_MLA = ZooSizes(batch=8, prompt=32, steps=32, check_steps=8,
                     timed_steps=8, layers=4, f32_layers=2, slots=4,
                     requests=((8, 16), (48, 16), (16, 16), (40, 16),
                               (24, 16), (32, 16), (12, 16), (44, 16)))
SERVE_ENCDEC = ZooSizes(batch=8, prompt=32, steps=32, check_steps=8,
                        timed_steps=8)
SERVE_VLM = ZooSizes(batch=4, prompt=32, steps=32, check_steps=8,
                     timed_steps=8)
# the same paths at sizes a CPU runs in seconds (a rehearsal only)
SERVE_MLA_SMOKE = ZooSizes(batch=2, prompt=5, steps=3, check_steps=3,
                           timed_steps=2, layers=3, f32_layers=2, slots=2,
                           requests=((3, 4), (6, 3), (2, 5)))
SERVE_ZOO_SMOKE = ZooSizes(batch=2, prompt=5, steps=3, check_steps=3,
                           timed_steps=2)


# no phase of this slice may hold more device memory than this
PEAK_LIMIT = 75e9


def check_peak(dev, what: str) -> Optional[int]:
    """The device's peak allocation since the last reset, held under
    ``PEAK_LIMIT``; None off the card."""
    if dev.type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated()
    check(peak < PEAK_LIMIT, f"{what}: peak device memory {peak / 1e9:.1f} "
          f"GB (limit {PEAK_LIMIT / 1e9:.0f} GB)")
    return peak


def check_no_launches(got: dict, what: str) -> None:
    """None of the ported TPU kernels launched: the MLA, encdec and vlm
    serving paths, the GSPMD step and GPipe reach no Pallas kernel in
    the reference, and none here (the attention kernel, which replaces
    none, runs in their models)."""
    check(not any(n for k, n in got.items() if k != "flash_attention"),
          f"{what}: kernels launched {got}")


def no_drop(cfg):
    """``cfg`` with a MoE capacity that drops no token of a batched
    forward (every expert's slots at least its group's tokens): the
    forward then computes what single-token decode does, which never
    drops.  Non-MoE configs come back as they are."""
    if cfg.family != "moe":
        return cfg
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=(m.n_experts + 1) / m.top_k))


def forward_vs_decode(model, params, toks, steps: int, dev, rel: float,
                      context=None, replay: bool = False) -> dict:
    """``Model.forward`` over ``toks`` [B, T + steps] (a MoE config
    without drops, :func:`no_drop`) against ``prefill`` of the first T
    tokens and ``steps`` decode steps fed the rest: the logits of
    positions T-1 .. T+steps-1 within ``rel`` (:func:`hold_logits`).
    With ``replay`` a MoE stack's decode steps take the forward's expert
    choices, token by token (:class:`RoutingReplay`: a random bf16 router
    sits one rounding from a tie often, and a flipped choice computes
    another function); the record counts the rows whose own choice
    differed."""
    from repro_torch.models import Model

    b, n = toks.shape
    t = n - steps
    kw = {} if context is None else {"context": context}
    fwd = Model(no_drop(model.cfg), use_kernels=model.use_kernels)
    replay = replay and model.cfg.family == "moe"
    with torch.no_grad(), RoutingLog() as log:
        hidden, _ = fwd.forward(params, toks, **kw)
        want = fwd.logits(params, hidden[:, t - 1:])
    del hidden
    # the forward routes all B x n tokens at once, a decode step one
    # position of every row: per position, each MoE layer's choices
    routes = [r.reshape(b, n, -1)[:, i] for i in range(n)
              for r in log.calls]
    cache = model.init_cache(b, n + 1, params["embed"].dtype, device=dev)
    with RoutingReplay(routes) if replay else contextlib.nullcontext() as rr:
        lg, cache = model.prefill(params, toks[:, :t], cache, **kw)
        got = [lg]
        for i in range(steps):
            lg, cache = model.decode_step(params, toks[:, t + i], cache,
                                          t + i, **kw)
            got.append(lg)
    _sync(dev)
    out = hold_logits(list(want.unbind(1)), got, rel)
    if replay:
        out.update(routing_replayed=True, routing_rows_apart=rr.apart,
                   routing_rows=rr.rows)
    return out


def draw_gates_(params, gen) -> list:
    """Every vlm ``cross`` gate drawn in place from ``gen``: uniform in
    ±[0.3, 1.2] (the reference starts them at 0, where tanh(0) = 0 hides
    the cross attention).  Returns the drawn values."""
    drawn = []
    for name, blk in params["layers"].items():
        if not name.endswith("_cross"):
            continue
        for g in ("gate_attn", "gate_ffn"):
            x = blk[g]
            mag = 0.3 + 0.9 * torch.rand(x.shape, generator=gen,
                                         device=x.device)
            sign = torch.randint(0, 2, x.shape, generator=gen,
                                 device=x.device) * 2 - 1
            blk[g] = (mag * sign).to(x.dtype)
            drawn += blk[g].tolist()
    return drawn


def materialized_mla(p, x, cfg, n_heads: int, theta: float):
    """Causal MLA with every head's keys and values formed from the
    latents (``W_uk c ⊕ k_rope``, ``W_uv c``) and a plain softmax: what
    the absorbed-projection trick must equal."""
    from repro_torch.models import mla as MLA

    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None]
    q_nope, q_rope = MLA._queries(p, x, n_heads, cfg, pos, theta)
    c_kv, k_rope = MLA._latents(p, x, cfg, pos, theta)
    b = x.shape[0]
    k = torch.cat([(c_kv @ p["w_uk"]).reshape(b, t, n_heads,
                                              cfg.nope_head_dim),
                   k_rope[:, :, None].expand(b, t, n_heads, -1)], -1)
    v = (c_kv @ p["w_uv"]).reshape(b, t, n_heads, cfg.v_head_dim)
    s = torch.einsum("bqhd,bkhd->bhqk", torch.cat([q_nope, q_rope], -1),
                     k) / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    o = torch.einsum("bhqk,bkhv->bqhv", s.masked_fill(~causal, -1e30)
                     .softmax(-1), v)
    return o.reshape(b, t, -1) @ p["wo"]


def mla_checks(params, cfg, gen, dev, t: int = 64) -> dict:
    """One MLA layer's absorbed attention (``mla_attention``) against
    :func:`materialized_mla` on random f32 inputs within ``F32_REL`` of
    the largest |output|; and the latent cache's bytes a token against a
    128-head GQA cache's."""
    from repro_torch.models import mla as MLA

    p = params["rem"]["rem0_dense_self"]["attn"]
    x = torch.randn((2, t, cfg.d_model), generator=gen, device=dev)
    with torch.no_grad():
        got = MLA.mla_attention(p, x, n_heads=cfg.n_heads, cfg=cfg.mla,
                                rope_theta=cfg.rope_theta)
        want = materialized_mla(p, x, cfg.mla, cfg.n_heads, cfg.rope_theta)
    err = ((got - want).abs().max() / want.abs().max()).item()
    check(err <= F32_REL, f"absorbed MLA differs from the materialized "
          f"heads by {err:.3g} of the largest |output| (> {F32_REL})")
    m = cfg.mla
    latent = (m.kv_lora + m.rope_head_dim) * 2
    per_head = 2 * cfg.n_heads * (m.nope_head_dim + m.rope_head_dim) * 2
    return {"absorbed_vs_materialized_rel": err, "rel": F32_REL,
            "tokens": t, "cache_bytes_per_token_layer": latent,
            "gqa_cache_bytes_per_token_layer": 2 * cfg.n_heads * 128 * 2,
            "mha_192_cache_bytes_per_token_layer": per_head,
            "reduction_vs_gqa": 2 * cfg.n_heads * 128 * 2 / latent}


def encode_costs(model, params, toks, ctx, dev, steps: int) -> dict:
    """What re-encoding an encdec model's context on every call costs:
    ``steps`` decode steps after a prefill, timed with
    ``Model.decode_step`` (which re-encodes, as the reference's does) and
    with the context encoded once and passed to ``decode.decode_step``;
    the encoder alone."""
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T

    b, t = toks.shape
    cfg = model.cfg
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        enc = T.encode(params, cfg, ctx)
        _sync(dev)
        encode_ms = (time.perf_counter() - t0) * 1e3
        times = {"reencoded": [], "encoded_once": []}
        for how in times:
            cache = model.init_cache(b, t + steps + 1,
                                     params["embed"].dtype, device=dev)
            lg, cache = model.prefill(params, toks, cache, context=ctx)
            for i in range(steps):
                tok = lg.argmax(-1)
                _sync(dev)
                t0 = time.perf_counter()
                if how == "reencoded":
                    lg, cache = model.decode_step(params, tok, cache, t + i,
                                                  context=ctx)
                else:
                    lg, cache = D.decode_step(params, cfg, tok, cache, t + i,
                                              context=enc)
                _sync(dev)
                times[how].append((time.perf_counter() - t0) * 1e3)
    med = statistics.median
    return {"encode_ms": encode_ms,
            "decode_step_ms_reencoded": med(times["reencoded"]),
            "decode_step_ms_encoded_once": med(times["encoded_once"]),
            "step_ms": times}


def zoo_serve_path(cfg, seed: int, sizes: ZooSizes, *, device="cuda",
                   phase: str = "serve_mla") -> list[dict]:
    """An MLA, encdec or vlm model at full width on seeded random bf16
    weights made on the device (``sizes.layers`` cuts the depth), the
    served configuration, with its stub context (``synthetic_context``
    in bf16) where the family takes one; vlm gates drawn non-zero
    (:func:`draw_gates_`):

      * ``prefill`` of ``batch`` prompts of ``prompt`` tokens (decode
        ticks, the reference's prefill of these stacks), then ``steps``
        greedy ``decode_step``s, timed
      * with context: a second context gives logits apart by more than
        ``BF16_REL`` of the largest |logit| (encoder and cross attention
        live)
      * :func:`forward_vs_decode` over ``check_steps`` within ``BF16_REL``
      * encdec: :func:`encode_costs`
      * a profile of one decode step
      * MLA: :func:`engine_path` over ``requests`` (fresh one-slot
        engines to hold the completions)

    then the f32 check: :func:`forward_vs_decode` within ``F32_REL`` on
    the weights cast to f32 in place, or on a fresh f32 model of
    ``f32_layers``; MLA: :func:`mla_checks` and the engine again, where
    f32 leaves few near-ties to stop the comparison.  No ported kernel
    launches on these paths (:func:`check_no_launches`); each part's
    peak device memory stays under ``PEAK_LIMIT``."""
    from repro_torch import tree
    from repro_torch.models import Model

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    run_cfg = cfg if sizes.layers is None else \
        dataclasses.replace(cfg, n_layers=sizes.layers)
    model = Model(run_cfg)
    at_start = _fresh_peak(dev)
    t0 = time.perf_counter()
    params = model.init(gen, device=dev)
    gates = draw_gates_(params, gen) if cfg.family == "vlm" else []
    _sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree.tree_leaves(params))
    param_bytes = sum(x.numel() * x.element_size()
                      for x in tree.tree_leaves(params))
    n = sizes.prompt + sizes.check_steps
    toks = torch.randint(0, cfg.vocab, (sizes.batch, n), device=dev,
                         generator=gen)
    prompt = toks[:, :sizes.prompt]
    spec = model.context_inputs(sizes.batch)
    ctx = alt = None
    if spec is not None:
        from repro_torch.data.pipeline import synthetic_context

        (b, tc, d), dt = spec
        ctx, alt = (torch.from_numpy(synthetic_context(s, b, tc, d))
                    .to(dev, dt) for s in (seed, seed + 1))
    reset_counts()
    run_model(model, params, prompt[:, :2], 1, dev, context=ctx)  # warm-up
    run = run_model(model, params, prompt, sizes.steps, dev, context=ctx)
    if ctx is not None:
        other = run_model(model, params, prompt, 1, dev,
                          feed=run["tokens"], context=alt)
        apart = max(((a.float() - b.float()).abs().amax(-1)
                     / a.float().abs().amax(-1)).max().item()
                    for a, b in zip(run["logits"], other["logits"]))
        check(apart > BF16_REL, f"a second context moves the logits by "
              f"{apart:.3g} of the largest |logit| (<= {BF16_REL}): the "
              "context is not read")
    vs_fwd = forward_vs_decode(model, params, toks, sizes.check_steps, dev,
                               BF16_REL, context=ctx, replay=True)
    record = {
        "phase": phase, "program": "prefill_decode", "model": cfg.name,
        "layers": run_cfg.n_layers, "config_layers": cfg.n_layers,
        "allocated_at_start": at_start,
        "params": n_params, "param_bytes": param_bytes, "init_s": init_s,
        "batch": sizes.batch, "prompt": sizes.prompt, "steps": sizes.steps,
        "prefill_ms": run["prefill_ms"],
        "prefill_ms_per_tick": run["prefill_ms"] / sizes.prompt,
        "decode_ms_per_step": statistics.median(run["step_ms"]),
        "decode_tokens_per_s": sizes.batch
        / statistics.median(run["step_ms"]) * 1e3,
        "bf16_rel": BF16_REL, "prefill_vs_decode": vs_fwd,
        "top2_gap_rel_median": torch.cat(
            [_top2_gap(lg) / lg.float().abs().amax(-1)
             for lg in run["logits"]]).median().item(),
    }
    if gates:
        record["gates"] = gates
    if ctx is not None:
        record["context_b_vs_a_rel"] = apart
        record["context"] = list(ctx.shape)
    if cfg.family == "encdec":
        record["encode"] = encode_costs(model, params, prompt[:, :4], ctx,
                                        dev, sizes.timed_steps)
    launches = read_counts()
    check_no_launches(launches, f"{phase} prefill and decode")
    if cuda:
        cache = model.init_cache(sizes.batch, sizes.prompt + 2, device=dev)
        kw = {} if ctx is None else {"context": ctx}
        record["profile"] = {"decode_step": device_profile(
            lambda: model.decode_step(params, prompt[:, 0], cache,
                                      sizes.prompt, **kw))}
        del cache
    recs = [record]
    if sizes.requests:
        eng = engine_path(model, params, cfg, sizes, seed, dev, BF16_REL,
                          expect_kernels=False, phase=phase)
        check_no_launches(eng["launches"], f"{phase} engine")
        recs.append(eng)
    record["max_memory_allocated"] = check_peak(dev, phase)

    # the semantics check in f32
    model32 = model
    if sizes.f32_layers is not None:
        del params
        if cuda:
            torch.cuda.empty_cache()
        model32 = Model(dataclasses.replace(cfg, n_layers=sizes.f32_layers))
        params = model32.init(gen, device=dev)
    cast_params_(params, torch.float32)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    f32 = {"rel": F32_REL, "layers": model32.cfg.n_layers,
           "params": sum(x.numel() for x in tree.tree_leaves(params))}
    reset_counts()
    f32["prefill_vs_decode"] = forward_vs_decode(
        model32, params, toks, sizes.check_steps, dev, F32_REL,
        context=None if ctx is None else ctx.float())
    if cfg.mla is not None:
        record["mla"] = mla_checks(params, model32.cfg, gen, dev)
    check_no_launches(read_counts(), f"{phase} f32 check")
    if sizes.requests:
        # bf16 near-ties leave the fresh engines little to compare
        eng32 = engine_path(model32, params, model32.cfg, sizes, seed, dev,
                            F32_REL, expect_kernels=False, phase=phase)
        check_no_launches(eng32["launches"], f"{phase} f32 engine")
        check(eng32["fresh_engine_tokens_compared"] > 0,
              f"{phase}: the f32 engine compared no token")
        eng32["program"] = "engine_f32"
        recs.append(eng32)
    f32["max_memory_allocated"] = check_peak(dev, f"{phase} f32")
    record["f32_check"] = f32
    record["launches"] = launches
    del params
    if cuda:
        torch.cuda.empty_cache()
    for r in recs:
        r["phase_seconds"] = time.perf_counter() - t_phase
    return recs


# whisper-small trained on {"data": 8}: one 256-token sequence and its
# 1,500-frame context a rank; 3 checked steps a backend, then 20 steps of
# acis with AdamW warmup_cosine(3e-4, 5, 20)
TRAIN_ENCDEC = TrainSizes(batch=8, seq=256, steps=3, e2e_steps=20, ckpt_at=0,
                          log_every=1, lr=3e-4, warmup=5, bar=0.0)
TRAIN_ENCDEC_SMOKE = TrainSizes(batch=8, seq=16, steps=1, e2e_steps=4,
                                ckpt_at=0, log_every=1, lr=1e-2, warmup=1,
                                bar=0.0)
TRAIN_ENCDEC_BACKENDS = (("acis", None, {"data": 8}),
                         ("acis_compressed", "int8_hopquant", {"data": 8}))


def train_descent(cfg, seed: int, sizes: TrainSizes, dev, *,
                  expect_kernels: bool = True) -> dict:
    """``sizes.e2e_steps`` steps of ``acis`` with kernels on
    ``LocalMesh({"data": 8})``, AdamW with ``warmup_cosine(lr, warmup,
    e2e_steps)``, the batch and its context split over the ranks: the
    nll of the last step below the first (the reference's
    ``test_smoke_train_step_loss_decreases`` bar), ``fused_hop`` /
    ``fused_pack`` launched as the plan says x steps; step ms, tokens/s,
    peak memory and one profiled step split into forward + backward,
    sync and optimizer."""
    from repro_torch import tree
    from repro_torch.core import make_engine
    from repro_torch.data.pipeline import BigramStream, DataConfig
    from repro_torch.mesh import LocalMesh
    from repro_torch.models import Model
    from repro_torch.train import optimizer as O
    from repro_torch.train import step as S

    cuda = dev.type == "cuda"
    sync_dev = _dev_sync(dev)
    mesh = LocalMesh({"data": 8}, device=dev)
    stream = BigramStream(DataConfig(vocab=cfg.vocab, seq_len=sizes.seq,
                                     global_batch=sizes.batch, seed=7))
    model = Model(cfg)
    opt = O.adamw(O.warmup_cosine(sizes.lr, sizes.warmup, sizes.e2e_steps))
    eng = make_engine("acis")
    _fresh_peak(dev)
    st = S.init_state(model, opt, torch.Generator(device=dev)
                      .manual_seed(seed), eng, mesh=mesh, arenas=True)
    per_sync = expected_launches(eng.last_sync_program(), mesh)
    times: list = []
    step_fn = _timed_step(S.build_train_step_acis(model, opt, mesh, eng),
                          sync_dev, times)
    reset_counts()
    curve = []
    for step in range(sizes.e2e_steps):
        st, m = step_fn(st, train_batch(model, stream, step, dev))
        curve.append([step, float(m["nll"])])
    launches = read_counts()
    nll0, nll1 = curve[0][1], curve[-1][1]
    check(all(math.isfinite(v) for _, v in curve), "non-finite nll")
    check(nll1 < nll0 - sizes.bar, f"train_encdec: nll {nll0} -> {nll1} "
          "did not fall")
    if expect_kernels:
        check_launches(launches, per_sync, sizes.e2e_steps)
    peak = check_peak(dev, "train_encdec descent")
    profile = train_profile(model, opt, eng, st, train_batch(
        model, stream, sizes.e2e_steps, dev), mesh) if cuda else None
    med = statistics.median(times[1:] or times)
    return {"phase": "train_encdec", "program": "descent",
            "backend": "acis", "mesh": {"data": 8}, "model": cfg.name,
            "params": sum(p.numel() for p in tree.tree_leaves(st.params)),
            "global_batch": sizes.batch, "seq": sizes.seq,
            "context": [sizes.batch, cfg.encdec.encoder_seq, cfg.d_model],
            "steps": sizes.e2e_steps, "curve": curve,
            "nll_first": nll0, "nll_last": nll1,
            "step_ms": times, "median_step_ms": med,
            "tokens_per_s": sizes.batch * sizes.seq / (med * 1e-3),
            "launches_per_sync": per_sync, "launches": launches,
            "max_memory_allocated": peak, "profile": profile}


def train_encdec_path(cfg, seed: int, sizes: TrainSizes = TRAIN_ENCDEC, *,
                      device="cuda", expect_kernels: bool = True
                      ) -> list[dict]:
    """The train_encdec phase: the kernels-vs-plain step check
    (:func:`train_sync_check`, the batch's context split over the ranks
    with its tokens) on each backend of ``TRAIN_ENCDEC_BACKENDS``, then
    :func:`train_descent`."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    recs = [train_sync_check(cfg, seed, sizes, backend, comp, axes, dev,
                             expect_kernels=expect_kernels)
            for backend, comp, axes in TRAIN_ENCDEC_BACKENDS]
    recs.append(train_descent(cfg, seed, sizes, dev,
                              expect_kernels=expect_kernels))
    for r in recs:
        r["phase"] = "train_encdec"
        r["phase_seconds"] = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phases 20-23: the GSPMD train step, GPipe over "pipe", the
# sequence-parallel RG-LRU scan and the shape-only dry run
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GspmdSizes:
    """train_gspmd's sizes: ``train_e2e``'s traffic (global batch x seq,
    ``BigramStream(seed=7)``) on ``{"data": data, "model": model}``;
    ``checked`` f32 steps (AdamW at ``check_lr``) held to the acis step
    with the ``xla`` engine on ``{"data": data}``, then ``steps`` steps
    with ``warmup_cosine(lr, warmup, steps)`` whose nll must fall by
    ``bar``."""
    data: int
    model: int
    batch: int
    seq: int
    checked: int
    check_lr: float
    steps: int
    lr: float
    warmup: int
    bar: float


# 60 descent steps, cut from 100: the run went over its ceiling on slow
# hosts (PERF.md §4); the nll still has to fall by 0.5
TRAIN_GSPMD = GspmdSizes(data=4, model=2, batch=8, seq=256, checked=3,
                         check_lr=1e-2, steps=60, lr=3e-4, warmup=20,
                         bar=0.5)
TRAIN_GSPMD_SMOKE = GspmdSizes(data=2, model=2, batch=8, seq=16, checked=2,
                               check_lr=1e-2, steps=12, lr=1e-2, warmup=2,
                               bar=0.1)
# the f32 check against the acis xla step.  On every checked step the
# GSPMD step taken from the acis step's own state gives its nll and
# grad_norm within GSPMD_RTOL (grad_norm catches a replicated leaf's
# gradient summed where it should be averaged, or the reverse, which
# AdamW's scale invariance hides from the params and the nll), and its
# params every element within 2·lr and, in every leaf, more than
# GSPMD_CLOSE_SHARE of them within 1e-3·lr of the acis step's (the
# one-step rule of test_torch_train.py).  Along the two trajectories
# the nll stays within GSPMD_RTOL and the params end within the
# reference's own acis-vs-xla atol (test_train_substrate.py).  The
# trajectories' grad_norm and close share are recorded, not held: Adam
# moves an element with a near-zero gradient by up to ~lr on a rounding
# difference, and the next steps compound it
GSPMD_RTOL = 1e-5
GSPMD_PARAM_ATOL = 2.5e-2
GSPMD_CLOSE_SHARE = 0.99


def param_diffs(got, want, atol: float) -> dict:
    """Two param trees: the largest difference, each leaf's share of
    elements within ``atol`` (the smallest, the mean) and the three
    leaves with the smallest share."""
    from repro_torch import tree
    from repro_torch.sharding import rules

    paths = [rules._path_str(p) for p, _ in rules.leaves_with_paths(want)]
    worst, share = 0.0, []
    for path, p, q in zip(paths, tree.tree_leaves(got),
                          tree.tree_leaves(want)):
        d = (p.float() - q.float()).abs()
        worst = max(worst, float(d.max()))
        share.append((float((d <= atol).float().mean()), path))
    return {"max_abs_diff": worst, "atol": atol,
            "min_leaf_share": min(share)[0],
            "mean_leaf_share": statistics.fmean(s for s, _ in share),
            "lowest": sorted(share)[:3]}


def gspmd_profile(step, state, batch) -> dict:
    """One more step (its result dropped) under ``torch.profiler``, then
    its forward + backward and its optimizer each in a window of their
    own, and the collectives' device ms inside the forward + backward
    (CUDA events around each native collective)."""
    from repro_torch.sharding import native

    g, m = step.grads(state, batch)
    parts = {
        "step": device_profile(lambda: step(state, batch)),
        "forward_backward": device_profile(lambda: step.grads(state,
                                                              batch)),
        "optimizer": device_profile(lambda: step.update(state, g, m)),
    }
    for k in ("forward_backward", "optimizer"):
        parts[k].pop("top", None)
    with native.counting(timed=True) as log:
        step.grads(state, batch)
    parts["collectives"] = {"device_ms": log.device_ms(),
                            "count": len(log.entries),
                            "note": "CUDA events around each collective "
                                    "inside one forward + backward"}
    return parts


def train_gspmd_path(cfg, seed: int, sizes: GspmdSizes = TRAIN_GSPMD, *,
                     device="cuda") -> list[dict]:
    """The train_gspmd phase: ``build_train_step_gspmd`` (FSDP x TP, native
    collectives) on ``LocalMesh({"data": 4, "model": 2})``: every leaf's
    shard shape as ``param_specs`` says; ``sizes.checked`` f32 steps
    against the acis step with ``make_engine("xla")`` on ``{"data": 4}``
    (on every step the GSPMD step from the acis state: nll and grad_norm
    within ``GSPMD_RTOL`` relative, params within 2·lr and in every leaf
    more than ``GSPMD_CLOSE_SHARE`` of them within 1e-3·lr; the
    trajectories' nll within ``GSPMD_RTOL`` and params within
    ``GSPMD_PARAM_ATOL``); no kernel launched;
    ``sizes.steps`` bf16 steps whose nll must fall by ``sizes.bar``; one
    step's collective log by kind against ``build_train``'s count of the
    same step on the meta device (equal); step ms, tokens/s, peak memory
    and one profiled step."""
    from repro_torch import tree
    from repro_torch.core import make_engine
    from repro_torch.data.pipeline import BigramStream, DataConfig
    from repro_torch.launch import cells
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.mesh import LocalMesh
    from repro_torch.models import Model
    from repro_torch.sharding import native, rules
    from repro_torch.train import optimizer as O
    from repro_torch.train import step as S

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    sync_dev = _dev_sync(dev)
    axes = {"data": sizes.data, "model": sizes.model}
    mesh = LocalMesh(axes, device=dev)
    stream = BigramStream(DataConfig(vocab=cfg.vocab, seq_len=sizes.seq,
                                     global_batch=sizes.batch, seed=7))

    def gen():
        return torch.Generator(device=dev).manual_seed(seed)

    _fresh_peak(dev)
    reset_counts()
    # 1. f32: the baseline against the acis step with the xla engine
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", dtype="float32")
    m32 = Model(cfg32)
    opt = O.adamw(lr=sizes.check_lr)
    gstep = S.build_train_step_gspmd(m32, opt, mesh)
    gst = gstep.place_state(S.init_state(m32, opt, gen(), device=dev))
    for x, s, y in zip(tree.tree_leaves(m32.param_shapes()),
                       rules.spec_leaves(gstep.state_specs.params),
                       tree.tree_leaves(gst.params)):
        rules.constrain(y, mesh, s, tuple(x.shape))   # raises if wrong
    astep = S.build_train_step_acis(m32, opt, LocalMesh(
        {"data": sizes.data}, device=dev), make_engine("xla"))
    ast = S.init_state(m32, opt, gen(), device=dev)
    def rel(pairs):
        return max(abs(x - y) / abs(y) for x, y in pairs)

    traj = {"nll": [], "grad_norm": []}     # [gspmd, acis] a step
    same = {"nll": [], "grad_norm": []}     # gspmd from the acis state
    steps = []                              # its params against acis's
    lr = sizes.check_lr
    for i in range(sizes.checked):
        b = stream.batch(i)
        sst, sm = gstep(gstep.place_state(ast), b)
        gst, gm = gstep(gst, b)
        ast, am = astep(ast, b)
        for k in traj:
            traj[k].append([float(gm[k]), float(am[k])])
            same[k].append([float(sm[k]), float(am[k])])
            check(rel(same[k][-1:]) <= GSPMD_RTOL, f"train_gspmd: step "
                  f"{i} from the same state: {k} {same[k][-1]} differ "
                  f"from the acis xla step's by {rel(same[k][-1:])} "
                  f"relative (limit {GSPMD_RTOL})")
        d = param_diffs(gstep.unshard_state(sst).params, ast.params,
                        1e-3 * lr)
        del sst
        steps.append(d)
        check(d["max_abs_diff"] <= 2 * lr, f"train_gspmd: step {i} from "
              f"the same state moved a param {d['max_abs_diff']} from the "
              f"acis xla step's (limit {2 * lr})")
        check(d["min_leaf_share"] > GSPMD_CLOSE_SHARE, f"train_gspmd: "
              f"step {i} from the same state: leaves {d['lowest']} have "
              f"fewer than {GSPMD_CLOSE_SHARE} of their elements within "
              f"{1e-3 * lr} of the acis xla step's")
    rel_err = {"nll": rel(traj["nll"]),
               "same_state_nll": rel(same["nll"]),
               "same_state_grad_norm": rel(same["grad_norm"])}
    check(rel_err["nll"] <= GSPMD_RTOL, f"train_gspmd: nll {traj['nll']} "
          f"differ from the acis xla step's by {rel_err['nll']} relative "
          f"(limit {GSPMD_RTOL})")
    whole = gstep.unshard_state(gst)
    end = param_diffs(whole.params, ast.params, 1e-3 * lr)
    param_err = end["max_abs_diff"]
    check(param_err <= GSPMD_PARAM_ATOL, f"train_gspmd: params differ from "
          f"the acis xla step's by {param_err}")
    del gst, ast, whole, gstep, astep
    # 2. the descent in the config's dtypes
    model = Model(cfg)
    opt = O.adamw(O.warmup_cosine(sizes.lr, sizes.warmup, sizes.steps))
    step = S.build_train_step_gspmd(model, opt, mesh)
    st = step.place_state(S.init_state(model, opt, gen(), device=dev))
    times: list = []
    run = _timed_step(step, sync_dev, times)
    curve = []
    for i in range(sizes.steps):
        st, m = run(st, stream.batch(i))
        curve.append([i, float(m["nll"])])
    nll0, nll1 = curve[0][1], curve[-1][1]
    check(all(math.isfinite(v) for _, v in curve), "non-finite nll")
    check(nll1 < nll0 - sizes.bar, f"train_gspmd: nll {nll0} -> {nll1} "
          f"fell by less than {sizes.bar}")
    # 3. one step's collectives against the meta-device count
    batch = stream.batch(sizes.steps)
    with native.counting() as log:
        step(st, batch)
    t_meta = time.perf_counter()
    built = cells.build_train(
        cfg, ShapeCell("train_e2e", sizes.seq, sizes.batch, "train"),
        LocalMesh(axes, device="meta"), microbatches=1, optimizer=opt)
    t_meta = time.perf_counter() - t_meta
    check(log.summary() == built.log.summary(), "train_gspmd: the step's "
          f"collectives {log.summary()} are not the meta-device count "
          f"{built.log.summary()}")
    launches = read_counts()
    check_no_launches(launches, "train_gspmd")
    peak = check_peak(dev, "train_gspmd")
    profile = gspmd_profile(step, st, batch) if cuda else None
    med = statistics.median(times[1:] or times)
    return [{"phase": "train_gspmd", "program": "build_train_step_gspmd",
             "mesh": axes, "model": cfg.name,
             "params": sum(p.numel() for p in tree.tree_leaves(
                 model.param_shapes())),
             "tp_plan": {"attention": step.tp_plan[0],
                         "ffn": step.tp_plan[1]},
             "global_batch": sizes.batch, "seq": sizes.seq,
             "f32_check": {"steps": sizes.checked, **traj,
                           "same_state": same,
                           "max_rel_diff": rel_err, "rtol": GSPMD_RTOL,
                           "grad_norm_max_rel_diff": rel(traj["grad_norm"]),
                           "same_state_params": steps,
                           "param_max_abs_diff": param_err,
                           "param_atol": GSPMD_PARAM_ATOL,
                           "trajectory_params": end,
                           "against": "build_train_step_acis(make_engine("
                                      f"'xla')) on {{'data': {sizes.data}}}"},
             "steps": sizes.steps, "curve": curve[::10] + [curve[-1]],
             "nll_first": nll0, "nll_last": nll1,
             "step_ms": times, "median_step_ms": med,
             "tokens_per_s": sizes.batch * sizes.seq / (med * 1e-3),
             "collectives": {"per_rank_bytes_by_kind": log.bytes_by_kind(),
                             "by_kind_and_direction": log.summary(),
                             "meta_count_equal": True,
                             "meta_build_s": t_meta},
             "activation_pins": step.last["act"].summary(),
             "launches": launches, "max_memory_allocated": peak,
             "profile": profile,
             "phase_seconds": time.perf_counter() - t0}]


@dataclasses.dataclass(frozen=True)
class PipeSizes:
    """The pipeline phase's sizes: ``stages`` stages of the model's blocks
    on ``LocalMesh({"pipe": stages})``, ``microbatches`` of ``mb x seq``
    embedded tokens."""
    stages: int
    microbatches: int
    mb: int
    seq: int
    reps: int


PIPELINE = PipeSizes(stages=4, microbatches=8, mb=1, seq=256, reps=3)
PIPELINE_SMOKE = PipeSizes(stages=2, microbatches=3, mb=1, seq=8, reps=1)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (the serving phases' rule)."""
    top = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / top if top \
        else float((got.float() - want.float()).abs().max())


def _int8_half_step(sent: torch.Tensor, nd: int) -> torch.Tensor:
    """Half the int8 codec's step for every element of ``sent`` (each
    rank's payload flattened into blocks of ``QBLOCK``, step = block
    absmax / 127), plus the two roundings of y / step and q * step."""
    from repro_torch.core.wire import QBLOCK

    flat = sent.float().reshape(sent.shape[:nd] + (-1,))
    size = flat.shape[-1]
    pad = (-size) % QBLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(
        flat.shape[:-1] + (-1, QBLOCK))
    amax = blocks.abs().amax(-1, keepdim=True)
    step = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    half = (step / 2).expand(blocks.shape).reshape(flat.shape[:-1] + (-1,))
    return (half[..., :size] + flat.abs() * 2.0 ** -22).reshape(sent.shape)


def pipeline_path(cfg, seed: int, sizes: PipeSizes = PIPELINE, *,
                  device="cuda") -> list[dict]:
    """The pipeline phase: the model's blocks in ``sizes.stages`` stages
    through ``run_pipeline`` (GPipe, ``M + S - 1`` ticks) on
    ``LocalMesh({"pipe": S})``, over embedded microbatches: with
    ``IDENTITY`` held against the blocks applied in sequence (within
    ``F32_REL`` of the largest magnitude in f32, ``BF16_REL`` in bf16);
    with the int8 wire codec every handoff within half the codec's
    per-block absmax step of what was sent, and every stage's output
    the stage applied to what it received (``F32_REL``)."""
    from repro_torch import tree
    from repro_torch.core.wire import WireCodec, int8_codec
    from repro_torch.mesh import LocalMesh
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.train.pipeline import run_pipeline

    dev = torch.device(device)
    t0 = time.perf_counter()
    sync_dev = _dev_sync(dev)
    _fresh_peak(dev)
    reset_counts()
    s = sizes.stages
    per = cfg.n_layers // s
    check(per * s == cfg.n_layers, f"{cfg.n_layers} layers in {s} stages")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    blocks = params["layers"]["pos0_self"]            # leaves [L, ...]
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab, (sizes.microbatches, sizes.mb,
                                        sizes.seq), generator=gen,
                         device=dev)
    x = L.embed_lookup(params["embed"], toks)       # [M, mb, T, D]
    del params
    mesh = LocalMesh({"pipe": s}, device=dev)

    def stage_fn(p, xin):            # p [S, 1, per, ...]; xin [S, mb, T, D]
        for lp in T.layer_views(tree.tree_map(lambda q: q[:, 0], p), dim=1):
            xin, _ = T.apply_block(lp, xin, cfg, "self")
        return xin

    def one_stage(bl, k, xin):        # stage k alone, no rank dims
        for lp in T.layer_views(tree.tree_map(
                lambda q: q[k * per:(k + 1) * per], bl)):
            xin, _ = T.apply_block(lp, xin, cfg, "self")
        return xin

    def stacked(bl):
        return tree.tree_map(lambda p: p.reshape((s, per) + p.shape[1:]), bl)

    def sequential(bl, xin):
        y = xin.reshape((-1,) + xin.shape[2:])
        for k in range(s):
            y = one_stage(bl, k, y)
        return y.reshape(xin.shape)

    out: dict = {"phase": "pipeline", "program": "run_pipeline",
                 "model": cfg.name, "stages": s, "layers_per_stage": per,
                 "microbatches": sizes.microbatches, "mb": sizes.mb,
                 "seq": sizes.seq, "ticks": sizes.microbatches + s - 1}
    with torch.no_grad():
        for name, dt, rel in (("bf16", torch.bfloat16, BF16_REL),
                              ("f32", torch.float32, F32_REL)):
            bl = tree.tree_map(lambda p: p.to(dt) if p.is_floating_point()
                               else p, blocks)
            xd = x.to(dt)
            times = []
            for _ in range(sizes.reps):
                sync_dev()
                t1 = time.perf_counter()
                got = run_pipeline(mesh, stage_fn, stacked(bl), xd)
                sync_dev()
                times.append((time.perf_counter() - t1) * 1e3)
            want = sequential(bl, xd)
            err = _rel_err(got, want)
            check(bool(torch.isfinite(got).all()), f"pipeline {name}: "
                  "non-finite output")
            check(err <= rel, f"pipeline {name}: {err} of the largest "
                  f"magnitude from the sequential blocks (limit {rel})")
            out[name] = {"rel_err": err, "limit": rel, "ms": times,
                         "median_ms": statistics.median(times),
                         "bitwise": bool(torch.equal(got, want))}
        # the int8 wire codec on the handoffs, recorded
        bl = tree.tree_map(lambda p: p.float() if p.is_floating_point()
                           else p, blocks)
        base = int8_codec()
        sent, recv = [], []

        def enc(y):
            sent.append(y)
            return base.encode(y)

        def dec(p):
            r = base.decode(p)
            recv.append(r)
            return r

        codec = WireCodec("int8_recorded", enc, dec,
                          wire_ratio=base.wire_ratio)
        got = run_pipeline(mesh, stage_fn, stacked(bl), x.float(), codec)
        check(len(sent) == out["ticks"], f"{len(sent)} handoffs")
        step_err = max(float(((r - y).abs() / _int8_half_step(y, 1)).max())
                       for y, r in zip(sent, recv))
        check(step_err <= 1.0, f"pipeline int8: a handoff moved a value by "
              f"{step_err} of half the codec's step")
        stage_err, replayed = 0.0, 0
        for t in range(out["ticks"] - 1):
            for k in range(1, s):
                mb_id = t + 1 - k
                if not 0 <= mb_id < sizes.microbatches:
                    continue
                y = one_stage(bl, k, recv[t][k - 1])
                stage_err = max(stage_err, _rel_err(sent[t + 1][k], y))
                replayed += 1
        check(stage_err <= F32_REL, f"pipeline int8: a stage's output is "
              f"{stage_err} from the stage applied to what it received")
        last = torch.stack([sent[j + s - 1][s - 1]
                            for j in range(sizes.microbatches)])
        check(torch.equal(got, last), "pipeline int8: the output is not "
              "the last stage's")
        ident = sequential(bl, x.float())
        out["int8"] = {"handoff_err_over_half_step": step_err,
                       "stage_replay_rel_err": stage_err,
                       "stages_replayed": replayed,
                       "vs_identity_rel": _rel_err(got, ident)}
    out["launches"] = read_counts()
    check_no_launches(out["launches"], "pipeline")
    out["max_memory_allocated"] = check_peak(dev, "pipeline")
    out["phase_seconds"] = time.perf_counter() - t0
    return [out]


@dataclasses.dataclass(frozen=True)
class SeqSizes:
    """The seq_parallel phase's sizes: ``rglru_scan_sp`` over ``ranks``
    chunks of a ``[batch, seq, width]`` f32 recurrence, the float64 check
    on ``lanes`` lanes, ``reps`` timed calls each way."""
    ranks: int
    batch: int
    seq: int
    width: int
    lanes: int
    reps: int


SEQ_PARALLEL = SeqSizes(ranks=8, batch=1, seq=524288, width=4096, lanes=64,
                        reps=3)
SEQ_PARALLEL_SMOKE = SeqSizes(ranks=8, batch=1, seq=2048, width=32,
                              lanes=8, reps=1)


def seq_parallel_path(seed: int, sizes: SeqSizes = SEQ_PARALLEL, *,
                      device="cuda", expect_kernels: bool = True
                      ) -> list[dict]:
    """The seq_parallel phase: ``rglru_scan_sp`` at recurrentgemma-9b's
    ``lru_width`` over ``LocalMesh({"data": 8})``, every rank a chunk of
    T: decays ``a = 1 - 10^u`` (u uniform in [-6, -1], so some lanes
    carry state across whole chunks) and normal ``b``, f32.  One call,
    one ``rglru_scan`` launch (every rank's chunk in it); held against
    one launch over the whole T and, on ``sizes.lanes`` lanes, against
    the float64 recurrence within ``sp_tolerance`` (the split) and the
    time-order bound (the whole); timed against the whole launch."""
    from repro_torch.kernels import chunk_scan as CS
    from repro_torch.mesh import LocalMesh
    from repro_torch.models import rglru as RG

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    _fresh_peak(dev)
    n, tc = sizes.ranks, sizes.seq // sizes.ranks
    check(n * tc == sizes.seq, "T does not split over the ranks")
    gen = torch.Generator(device=dev).manual_seed(seed)
    # rank-stacked: [ranks, B, T/n, W] is P(None, "data", None) of [B, T, W]
    shape = (n, sizes.batch, tc, sizes.width)
    a = torch.empty(shape, device=dev).uniform_(-6.0, -1.0, generator=gen)
    a.mul_(math.log(10.0)).exp_().neg_().add_(1.0)
    b = torch.randn(shape, generator=gen, device=dev)
    mesh = LocalMesh({"data": n}, device=dev)

    def whole_view(x):        # [ranks, B, T/n, W] -> [B, T, W]
        return x.transpose(0, 1).reshape(sizes.batch, sizes.seq,
                                         sizes.width)

    def split():
        with torch.no_grad(), mesh:
            return RG.rglru_scan_sp(a, b, "data")

    reset_counts()
    h = split()
    launches = read_counts()
    if expect_kernels:
        check(launches["rglru_scan"] == 1, f"rglru_scan_sp launched "
              f"rglru_scan {launches['rglru_scan']} times, not once")
    peak_sp = torch.cuda.max_memory_allocated() if cuda else None
    # the comparison launch over the whole T (not counted)
    aw, bw = whole_view(a), whole_view(b)
    whole = CS.rglru_scan(aw, bw)
    hw = whole_view(h)
    diff_all = float((hw - whole).abs().max())
    top_all = float(whole.abs().max())
    lanes = torch.randperm(sizes.width, generator=gen, device=dev)[
        :sizes.lanes].sort().values
    al, bl = aw[..., lanes], bw[..., lanes]
    exact, tol = RG.sp_tolerance(al, bl, n)
    _, tol_whole = RG.scan_bound(al.double(), bl.double())
    sp_ratio = float(((hw[..., lanes].double() - exact).abs() / tol).max())
    whole_ratio = float(((whole[..., lanes].double() - exact).abs()
                         / tol_whole).max())
    check(sp_ratio <= 1.0, f"seq_parallel: the split scan is {sp_ratio} "
          "of sp_tolerance from the float64 recurrence")
    check(whole_ratio <= 1.0, f"seq_parallel: the whole launch is "
          f"{whole_ratio} of its bound from the float64 recurrence")
    lane_diff = float((hw[..., lanes].double()
                       - whole[..., lanes].double()).abs().max())
    check(lane_diff <= float((tol + tol_whole).max()), "seq_parallel: split "
          "and whole differ beyond their bounds")
    del exact, tol, tol_whole, h, whole, hw
    out = {"phase": "seq_parallel", "program": "rglru_scan_sp",
           "mesh": {"data": n}, "shape": [sizes.batch, sizes.seq,
                                          sizes.width],
           "steps_per_rank": tc, "dtype": "float32",
           "lanes_checked": sizes.lanes,
           "sp_err_over_bound": sp_ratio, "whole_err_over_bound": whole_ratio,
           "all_lanes_max_abs_diff_vs_whole": diff_all,
           "all_lanes_max_abs": top_all, "launches": launches,
           "peak_after_split_call": peak_sp}
    if cuda:
        def whole_call():
            return CS.rglru_scan(aw, bw)
        out["ms"] = time_ms(split, reps=sizes.reps, inner=1)
        out["whole_ms"] = time_ms(whole_call, reps=sizes.reps, inner=1)
        # the split call's one launch alone (its chunks' local scans)
        out["local_scan_ms"] = time_ms(lambda: CS.rglru_scan(a, b),
                                       reps=sizes.reps, inner=1)
        # bytes the split call must move: a and b read, h written
        out["bound_ms"] = 3 * a.numel() * 4 / device_peaks(
            torch.cuda.get_device_name(dev))[0] * 1e3
    out["max_memory_allocated"] = check_peak(dev, "seq_parallel")
    del a, b, aw, bw
    if cuda:
        torch.cuda.empty_cache()
    out["phase_seconds"] = time.perf_counter() - t0
    return [out]


# the dry run's cells on the card's host: qwen3-8b x train_4k on the
# single-pod mesh (probes composed) and the multi-pod mesh (no probes)
DRYRUN_CELLS = (("qwen3-8b", "train_4k", False),
                ("qwen3-8b", "train_4k", True))


def dryrun_start(cells=DRYRUN_CELLS) -> dict:
    """Start ``python -m repro_torch.launch.dryrun`` for each cell, one
    process each, on the CPU (no card visible to them): they run while
    the card's phases do."""
    import tempfile

    d = tempfile.mkdtemp(dir=ROOT, prefix=".chip_smoke_dryrun_")
    # one thread each, at a lower priority: the card's phases keep the
    # host's cores they dispatch from
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", PYTHONPATH=str(ROOT / "src"))
    jobs = []
    for arch, shape, mp in cells:
        out = os.path.join(d, f"{arch}__{shape}__{'mp' if mp else 'sp'}")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", out + ".json"]
        if mp:
            cmd.append("--multi-pod")
        log = open(out + ".log", "w")
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                env=env, cwd=str(ROOT),
                                preexec_fn=lambda: os.nice(10))
        jobs.append({"cell": [arch, shape, mp], "out": out, "log": log,
                     "t0": time.perf_counter(), "proc": proc})
    return {"dir": d, "jobs": jobs}


def dryrun_stop(started: dict) -> None:
    """Kill whatever is still running and remove the records' directory."""
    for j in started["jobs"]:
        if j["proc"].poll() is None:
            j["proc"].kill()
        j["proc"].wait()
        j["log"].close()
    shutil.rmtree(started["dir"], ignore_errors=True)


def dryrun_finish(started: dict, timeout: float = 600.0) -> list[dict]:
    """Wait for the dry-run processes and read their records: the
    bottleneck, the three roofline terms (the cost model's against one
    H100's published peaks, not card times), ``useful_flops_ratio``,
    the per-rank memory and the seconds each took."""
    recs = []
    try:
        for j in started["jobs"]:
            rc = j["proc"].wait(timeout=max(1.0, timeout - (
                time.perf_counter() - j["t0"])))
            j["log"].flush()
            tail = Path(j["out"] + ".log").read_text()[-2000:]
            check(rc == 0, f"dryrun {j['cell']} failed:\n{tail}")
            r = json.loads(Path(j["out"] + ".json").read_text())
            rec = {"phase": "dryrun", "cell": j["cell"], "mesh": r["mesh"],
                   "seconds": r["seconds"], "build_s": r["build_s"],
                   "memory_analysis": r["memory_analysis"],
                   "tp_plan": r["tp_plan"],
                   "activation_pins": r["activation_pins"]}
            if "bottleneck" in r:
                rec.update({k: r[k] for k in (
                    "bottleneck", "bottleneck_cc", "t_compute_s",
                    "t_memory_s", "t_collective_s", "useful_flops_ratio",
                    "roofline_fraction", "probe_composition", "peaks")})
                rec["note"] = ("roofline terms are the cost model's, "
                               "not times on the card")
            recs.append(rec)
    finally:
        dryrun_stop(started)
    return recs


# device kernels of a ring sync counted by name: PyTorch's rolls and its
# index kernels (the per-rank gathers and the all-gather's puts), and the
# hand-written hops, combines and pack
RING_OPS = {"rolls": "roll_cuda_kernel",
            "gathers_and_puts": "index_elementwise_kernel",
            "fused_hop": "::hop_kernel", "fused_gather": "gather_kernel",
            "fused_pack": "pack_kernel",
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
# phase 24: the examples, each twin's main() on the card
# ---------------------------------------------------------------------------

# The twins in the order the phase runs them (train_e2e runs in the train
# phase, whose resume check drives it), and the ported kernels each one's
# path reaches: each group is one kernel of the reference, counted by its
# elementwise and ring-hop forms together (kernel_modules() names).
EXAMPLES = ("quickstart", "fused_collectives", "hierarchical_sync",
            "cgra_simulate", "serve_batched")
COMBINE = ("fused_combine", "fused_hop")
QUANT = ("quant_combine", "quant_hop")
EXAMPLE_KERNELS = {
    "quickstart": (COMBINE, ("prefix_sum",)),
    "fused_collectives": (COMBINE, ("prefix_sum",)),
    "hierarchical_sync": (COMBINE, QUANT),
    "cgra_simulate": (COMBINE, QUANT, ("prefix_sum",)),
    "serve_batched": (COMBINE,),
    # the default int8 compressor's exact int16 ring has no kernel; its
    # bucket packs do
    "train_e2e": (("fused_pack",),),
}


def load_example(name: str):
    """``examples/torch_<name>.py``, the port's twin of an example of the
    reference, as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def printed(out):
    """The numbers and names of a twin's result (what it prints): every
    int, float, str, bool and the lists, tuples and dicts of them;
    tensors, arrays and objects left out."""
    if isinstance(out, dict):
        kept = {str(k): printed(v) for k, v in out.items()}
        return {k: v for k, v in kept.items() if v is not None}
    if isinstance(out, (list, tuple)):
        kept = [printed(v) for v in out]
        return kept if all(v is not None for v in kept) else None
    if isinstance(out, (bool, int, float, str)):
        return out
    return None


def _rel(got, want) -> float:
    """max |got - want| over max |want|, in float64."""
    got = torch.as_tensor(got).double().cpu()
    want = torch.as_tensor(want).double().cpu()
    return ((got - want).abs().max() / want.abs().max()).item()


def all_to_all_want(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The global result of ``all_to_all`` over ``n`` ranks of a 1-D
    tensor split over them: rank j holds chunk j of every rank, by
    source rank."""
    return keys.reshape(n, n, -1).transpose(0, 1).reshape(-1)


def quickstart_checks(out: dict, cfg) -> dict:
    """Fig. 5 exact on its integer input, the NAS IS pair (8 in every
    histogram lane, the keys all-to-all'd), Welford within 1e-5 of
    numpy's, the forward's hidden states finite at ``cfg``'s width."""
    check(out["fig5_stages"] == ["scan+allgather"] and
          out["nas_is_stages"] == ["allreduce+alltoall"],
          f"quickstart: stages {out['fig5_stages']}, {out['nas_is_stages']}")
    x = torch.arange(32.0, dtype=torch.float64)
    check(torch.equal(out["fig5_out"].cpu().double(), x.cumsum(0)),
          "quickstart: Fig. 5's scan of 0..31 is not exact")
    check(bool((out["hist"] == 8).all()), "quickstart: a histogram lane "
          "is not 8")
    check(torch.equal(out["keys"].cpu(), all_to_all_want(
        torch.arange(64.0), 8)), "quickstart: the keys' all-to-all")
    rel = {"welford_mean_rel": _rel(out["welford_mean"][:8],
                                    out["numpy_mean"]),
           "welford_var_rel": _rel(out["welford_var"][:8],
                                   out["numpy_var"])}
    check(max(rel.values()) <= 1e-5, f"quickstart: Welford off numpy's "
          f"by {rel}")
    check(out["hidden_finite"] and out["hidden_shape"] == (2, 16,
                                                           cfg.d_model),
          f"quickstart: hidden {out['hidden_shape']}")
    return rel


def fused_collectives_checks(out: dict) -> dict:
    """The matches the tour prints all true; the bf16 ring within 8 bf16
    roundings of the largest lane's sum of |x|; the EF sync's mean equal
    to the mean of what the wire delivered (target - residual) within
    f32 rounding; PowerSGD's ranks holding one result; the traced DAG's
    stages and schedules, its reduce (8 in every lane) and all-to-all."""
    check(out["max_match"] and out["fused_match"] and out["matmul_match"],
          "fused_collectives: a printed match is False")
    x = out["x"].double()
    scale = x.abs().sum(0).max().item()
    check(out["bf16_err"] <= 8 * 2.0 ** -8 * scale,
          f"fused_collectives: bf16 ring off by {out['bf16_err']}")
    delivered = (x - out["ef_residual"].double()).mean(0)
    ef = (out["ef_reduced"][0].double() - delivered).abs().max().item()
    check(ef <= 2.0 ** -20 * scale, f"fused_collectives: the EF mean is "
          f"{ef} off the delivered mean")
    p = out["powersgd"]
    check(bool(torch.isfinite(p).all()) and bool((p == p[0:1]).all()),
          "fused_collectives: PowerSGD's ranks differ")
    check(out["dag_stages"] == ["map+allreduce", "alltoall"] and
          out["dag_schedules"] == ["latency", "-"],
          f"fused_collectives: DAG {out['dag_stages']} "
          f"{out['dag_schedules']}")
    check(bool((out["dag_hist"] == 8).all()) and torch.equal(
        out["dag_keys"].cpu(), all_to_all_want(torch.arange(8192.0), 8)),
        "fused_collectives: the DAG's outputs")
    return {"ef_mean_err": ef, "bf16_err_over_scale": out["bf16_err"] / scale}


# the int8 pod hop quantizes each pod's partial sum and the sum of the
# two, each to half a step of its 256-lane block's absmax / 127: three
# half-steps of the largest per-pod sum of |g|
INT8_POD_REL = 3 / 254
HIER_STAGES = ["map", "reduce_scatter", "allreduce", "allgather", "map"]


def hierarchical_sync_checks(out: dict) -> dict:
    """Both programs lowered to the five hierarchical stages with the
    engine's codec on the pod hop, each run on the mesh within its bound
    of the exact sum (f32 rounding; ``INT8_POD_REL`` for int8), the
    gradient sync within f32 rounding of the flat mean."""
    for backend, codec, bound in (
            ("acis_hierarchical", "identity", 1e-6),
            ("acis_hierarchical_compressed", "int8_b256", INT8_POD_REL)):
        p = out["programs"][backend]
        check(p["stages"] == HIER_STAGES and p["codec"] == codec,
              f"hierarchical_sync {backend}: {p['stages']} {p['codec']}")
        check(p["rel_err"] <= bound, f"hierarchical_sync {backend}: "
              f"{p['rel_err']} off the exact sum (bound {bound})")
    check(out["sync_err"] <= 1e-6, f"hierarchical_sync: gradient_sync "
          f"{out['sync_err']} off the flat mean")
    check(out["sync_stages"] == ["map", "reduce_scatter@data",
                                 "allreduce@pod", "allgather@data", "map",
                                 "map"],
          f"hierarchical_sync: sync stages {out['sync_stages']}")
    return {}


def cgra_simulate_checks(out: dict) -> dict:
    """Fig. 5's simulated scan the same on every rank and within
    ``scan_tolerance`` of the float64 sum; the int8 EF stage placed, the
    top-k one a host fallback; the hierarchical sum within
    ``INT8_POD_REL``; every report's times finite and positive (the cost
    model's)."""
    f = out["fig5"]
    got = f["out"].cpu()
    check(bool((got == got[0:1]).all()), "cgra_simulate: Fig. 5's ranks "
          "differ")
    exact, tol = scan_tolerance(torch.from_numpy(f["input"].reshape(-1)), 0)
    ratio = scan_err(got[0], exact, tol, "cgra_simulate: Fig. 5")
    check(not out["int8"]["placement"].startswith("host-fallback") and
          out["topk"]["placement"].startswith("host-fallback"),
          f"cgra_simulate: placements {out['int8']['placement']!r}, "
          f"{out['topk']['placement']!r}")
    h = out["hierarchical"]
    check(h["rel_err"] <= INT8_POD_REL, f"cgra_simulate: hierarchical sum "
          f"{h['rel_err']} off (bound {INT8_POD_REL})")
    for k in ("fig5", "int8", "topk", "hierarchical"):
        check(0 < out[k]["sim_us"] < math.inf and
              0 < out[k]["model_us"] < math.inf,
              f"cgra_simulate: {k} times {out[k]['sim_us']}, "
              f"{out[k]['model_us']}")
    return {"fig5_err_over_bound": ratio}


def serve_batched_checks(out: dict) -> dict:
    """(Request 3 against the greedy oracle is the twin's own assert.)
    Every burst's 10 requests complete with all their tokens; the
    second replica compiles nothing."""
    want = sum(4 + (i * 5) % 12 for i in range(10))
    for k in ("plain", "compiled", "replica2"):
        b = out[k]
        check(len(b["completions"]) == 10 and b["tokens"] == want,
              f"serve_batched {k}: {len(b['completions'])} completions, "
              f"{b['tokens']} tokens (want 10, {want})")
    check(out["replica2_new_compiles"] == 0,
          f"serve_batched: replica 2 compiled "
          f"{out['replica2_new_compiles']} programs")
    return {}


def examples_path(cfgs: dict, *, device="cuda",
                  expect_kernels: bool = True) -> list[dict]:
    """The examples phase: each twin of ``EXAMPLES`` through its ``main``
    on ``device`` (``cfgs`` by name: the model config a twin takes, a
    depth cut or a smoke config), its own asserts and the checks above;
    its host seconds, its launches (each group of ``EXAMPLE_KERNELS``
    launched) and its peak memory under ``PEAK_LIMIT``."""
    dev = torch.device(device)
    sync_dev = _dev_sync(dev)
    checks = {"quickstart": lambda o: quickstart_checks(
                  o, cfgs["quickstart"]),
              "fused_collectives": fused_collectives_checks,
              "hierarchical_sync": hierarchical_sync_checks,
              "cgra_simulate": cgra_simulate_checks,
              "serve_batched": serve_batched_checks}
    recs = []
    for name in EXAMPLES:
        twin = load_example(name)
        _fresh_peak(dev)
        reset_counts()
        sync_dev()
        t0 = time.perf_counter()
        out = twin.main([], device=dev, cfg=cfgs.get(name))
        sync_dev()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        rec = {"phase": "examples", "program": name,
               "example": f"examples/torch_{name}.py", "seconds": seconds,
               "checks": checks[name](out), "numbers": printed(out),
               "launches": launches}
        if expect_kernels:
            for group in EXAMPLE_KERNELS[name]:
                check(sum(launches[k] for k in group) > 0,
                      f"{name}: none of {group} launched")
        rec["max_memory_allocated"] = check_peak(dev, f"examples {name}")
        recs.append(rec)
    return recs


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
    "fused_gather": ("src/repro_torch/kernels/csrc/fused_combine.cu",
                     "none: the reference's all-gather is a ppermute loop"),
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
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "none: the reference's attention has no Pallas "
                        "kernel"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every phase's record to this JSON file")
    args = ap.parse_args()

    # deterministic cuBLAS for the train phase's resume check: the
    # workspace setting must be in place before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.kernels import build

    # full float32 matmuls (the GCN and PowerSGD programs, and their
    # float64-held bounds), stated and set rather than left to defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = []
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    peak, f32_peak, tensor_peak, peak_note = device_peaks(name)
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
           "tensor_peak_flops": tensor_peak,
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
    # the dry run (phase 23) runs on the host's CPU while the card works
    dry = dryrun_start()
    try:
        return _phases(args, smi, name, peak, f32_peak, records, dev, dry)
    finally:
        dryrun_stop(dry)


def _phases(args, smi, name, peak, f32_peak, records, dev, dry) -> int:
    from repro_torch.configs.acis_100m import CONFIG
    from repro_torch.configs.deepseek_v2_236b import CONFIG as DEEPSEEK
    from repro_torch.configs.llama_3_2_vision_11b import CONFIG as VISION
    from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as QWEN2_MOE
    from repro_torch.configs.qwen3_8b import CONFIG as QWEN3
    from repro_torch.configs.recurrentgemma_9b import CONFIG as RGEMMA
    from repro_torch.configs.rwkv6_1_6b import CONFIG as RWKV6
    from repro_torch.configs.whisper_small import CONFIG as WHISPER
    from repro_torch.mesh import LocalMesh

    checks = kernel_checks(dev)
    timings = kernel_timings(dev, peak, f32_peak, CONFIG, RWKV6, RGEMMA)
    rec = {"phase": "kernels", "checks": checks, "timings": timings}
    emit(rec)
    records.append(rec)

    plans = GatherPlans().start()
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
    for rec in train_path(CONFIG, args.seed):
        rec["card"] = smi
        paths.append(rec)
        emit(rec)
    for rec in serve_path(RWKV6, args.seed, SERVE):
        paths.append(rec)
        emit(rec)
    for rec in serve_path(RGEMMA, args.seed, SERVE_HYBRID,
                          phase="serve_hybrid"):
        paths.append(rec)
        emit(rec)
    for cfg, sizes, phase in ((QWEN3, SERVE_TP_DENSE, "serve_tp_dense"),
                              (QWEN2_MOE, SERVE_TP_MOE, "serve_tp_moe")):
        t0 = time.perf_counter()
        recs = tp_serve_path(cfg, args.seed, sizes, phase=phase)
        for rec in recs:
            rec["card"] = smi
            rec["phase_seconds"] = time.perf_counter() - t0
            paths.append(rec)
            emit(rec)
    for cfg, sizes, phase in ((DEEPSEEK, SERVE_MLA, "serve_mla"),
                              (WHISPER, SERVE_ENCDEC, "serve_encdec"),
                              (VISION, SERVE_VLM, "serve_vlm")):
        for rec in zoo_serve_path(cfg, args.seed, sizes, phase=phase):
            rec["card"] = smi
            paths.append(rec)
            emit(rec)
    for rec in train_encdec_path(WHISPER, args.seed):
        rec["card"] = smi
        paths.append(rec)
        emit(rec)
    for rec in (train_gspmd_path(CONFIG, args.seed)
                + pipeline_path(CONFIG, args.seed)
                + seq_parallel_path(args.seed)):
        rec["card"] = smi
        paths.append(rec)
        emit(rec)
    # the examples at full width; the quickstart's qwen3-8b at
    # serve_tp_dense's depth cut
    for rec in examples_path({"quickstart": dataclasses.replace(
            QWEN3, n_layers=SERVE_TP_DENSE.layers)}):
        rec["card"] = smi
        paths.append(rec)
        emit(rec)
    e2e = next(p for p in paths if p.get("program") == "train_e2e")
    rec = {"phase": "examples", "program": "train_e2e",
           "example": e2e["example"], "run_in": "train",
           "numbers": {k: e2e[k] for k in (
               "backend", "mesh", "model", "steps", "nll_first", "nll_last",
               "entropy", "example_seconds", "example_tokens_per_s",
               "sync_us_model", "arena_bytes", "wire_mb_f32",
               "wire_mb_int16")},
           "launches_in_train": e2e["launches"], "card": smi}
    records.append(rec)
    emit(rec)
    records.extend(paths)
    plans.stop()
    rec = plans.hold()
    records.append(rec)
    emit(rec)
    # the dry run's records: CPU processes, no launch of the card's
    for rec in dryrun_finish(dry):
        rec["card"] = smi
        records.append(rec)
        emit(rec)

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
