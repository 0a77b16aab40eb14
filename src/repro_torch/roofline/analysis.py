"""Roofline analysis of dry-run cells against one NVIDIA H100 SXM.

The port of :mod:`repro.roofline.analysis`.  Three terms per (arch ×
shape × mesh), in seconds per step on the TARGET card:

    compute    = FLOPs (per rank)           / 989e12  FLOP/s  (bf16 dense)
    memory     = bytes (per rank)           / 3.35e12 B/s     (HBM3)
    collective = wire bytes (per rank)      / 450e9   B/s     (NVLink, one way)

The peaks are the H100 SXM data sheet's (989 TFLOP/s dense bf16 on the
tensor cores, 3.35 TB/s HBM3, 900 GB/s NVLink 4 in both directions, so
450 GB/s each way), for a card at its 700 W limit: published peaks, not
measurements, and a card set below 700 W runs slower under load.

The counts come from the cell's run on the meta device
(:mod:`repro_torch.launch.cells`): matmul and attention FLOPs from
``torch.utils.flop_counter.FlopCounterMode``, an operand-plus-result
byte count of every non-view op (an upper bound: nothing is fused, as
the reference's CPU figure is not), and the collective log of the native
collectives (:mod:`repro_torch.sharding.native`); each divided by the
ranks the run held.  :func:`collective_bytes` is the reference's HLO
text parser, kept so the two can be held to each other on the same
text; the port's own collective bytes come from its log.

The dominant term is the bottleneck; MODEL_FLOPS / FLOPs measures how
much of the counted compute is algorithmically useful (remat and
replicated work over ``model`` lower it).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

PEAK_FLOPS = 989e12          # bf16 dense / card (H100 SXM data sheet)
HBM_BW = 3.35e12             # B/s / card (HBM3)
LINK_BW = 450e9              # B/s / card, NVLink 4, one direction
POWER_LIMIT_W = 700          # the limit the peaks assume
PEAK_SOURCE = ("H100 SXM data sheet at 700 W: 989 TFLOP/s bf16 dense, "
               "3.35 TB/s HBM3, 450 GB/s NVLink each way (published "
               "peaks, not measurements)")

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"\b([a-z][a-z0-9]*)\[([0-9,]*)\]")
_OP_RE = re.compile(
    r"=\s*(?:\([^=]*?\)|[a-z0-9\[\],{}:#* ]+?)\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\(")


def _shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    for d in dims.split(","):
        if d.strip():
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def collective_bytes(hlo_text: str) -> dict:
    """Per-device bytes moved by each collective kind (result shapes) in
    an HLO module's text."""
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        kind = m.group(1)
        # result type precedes the op name
        prefix = line[:m.end(1) - len(kind)]
        total = sum(_shape_bytes(dt, dims)
                    for dt, dims in _SHAPE_RE.findall(prefix))
        out[kind] += total
        counts[kind] += 1
    return {"bytes": out, "counts": counts,
            "total_bytes": sum(out.values())}


def log_bytes(log) -> dict:
    """The same record from a native collective log (per rank)."""
    out = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for e in log.entries:
        out[e.kind] += e.bytes
        counts[e.kind] += 1
    return {"bytes": out, "counts": counts,
            "total_bytes": sum(out.values())}


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                 # per rank
    hbm_bytes: float             # per rank
    coll_bytes: float            # per rank
    coll_detail: dict
    model_flops: float           # global, algorithmic
    per_device_bytes: Optional[float] = None   # peak memory (fits check)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bottleneck_cc(self) -> str:
        """Compute-vs-collective bottleneck: the memory term is an
        unfused operand-traffic upper bound, so the comm/compute
        comparison is the steadier signal."""
        return "compute" if self.t_compute >= self.t_collective \
            else "collective"

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """t_model_compute / t_step with t_step = max(terms) (perfect
        overlap)."""
        t_step = max(self.t_compute, self.t_memory, self.t_collective)
        t_useful = (self.model_flops / self.chips) / PEAK_FLOPS
        return t_useful / t_step if t_step else 0.0

    @property
    def roofline_fraction_cc(self) -> float:
        t_step = max(self.t_compute, self.t_collective)
        t_useful = (self.model_flops / self.chips) / PEAK_FLOPS
        return t_useful / t_step if t_step else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "collective_detail": self.coll_detail,
            "model_flops": self.model_flops,
            "per_device_peak_bytes": self.per_device_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "bottleneck_cc": self.bottleneck_cc,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "roofline_fraction_cc": self.roofline_fraction_cc,
            "peaks": PEAK_SOURCE,
        }


def model_flops_for(arch: str, shape_name: str) -> float:
    """Algorithmic FLOPs per step: 6·N·D train (N = active params for MoE),
    2·N·tokens for forward-only (prefill/decode)."""
    from repro_torch import configs
    from repro_torch.launch.shapes import SHAPES
    cfg = configs.get(arch)
    cell = SHAPES[shape_name]
    n = cfg.active_param_count()
    if cell.kind == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch       # one token per sequence


def _chips(mesh_desc: str) -> int:
    chips = 1
    for part in re.findall(r"(\d+)[a-z]", mesh_desc):
        chips *= int(part)
    return chips


def analyze(cell, model_flops: Optional[float] = None) -> Roofline:
    """The roofline record of a built cell
    (:class:`repro_torch.launch.cells.BuiltCell`): its three counts per
    rank, ``model_flops`` (the cell's own by default)."""
    c = cell.counts
    mem = cell.memory
    return Roofline(
        arch=cell.arch, shape=cell.shape, mesh=cell.mesh_desc,
        chips=_chips(cell.mesh_desc), flops=c["flops"],
        hbm_bytes=c["hbm_bytes"], coll_bytes=c["coll_bytes"],
        coll_detail=c["coll_detail"],
        model_flops=model_flops if model_flops is not None
        else model_flops_for(cell.arch, cell.shape),
        per_device_bytes=float(mem["temp_bytes"] + mem["argument_bytes"]
                               + mem["output_bytes"]))
