"""Public wrappers for the hand-written kernels.

Each wrapper is the drop-in, signature-compatible implementation of its
:mod:`repro_torch.kernels.ref` function: on a CUDA tensor it launches the
kernel, on a CPU tensor it runs the plain version.  These are the
kernels :func:`repro_torch.core.switchops.load_kernels` binds; the int8
codec binds ``quant_combine`` itself (:func:`repro_torch.core.wire.
int8_codec`), and kernels not ported yet wait in ROADMAP.md.
"""

from __future__ import annotations

from repro_torch.kernels import chunk_scan as _cs
from repro_torch.kernels import fused_combine as _fc
from repro_torch.kernels import pack_combine as _pc
from repro_torch.kernels import rwkv6_recurrence as _rw
from repro_torch.kernels import topk_accum as _ta


def combine_add(x, y):
    return _fc.fused_combine(x, y, op="add")


def combine_max(x, y):
    return _fc.fused_combine(x, y, op="max")


def combine_min(x, y):
    return _fc.fused_combine(x, y, op="min")


def combine_mac(acc, x, alpha: float = 1.0):
    return _fc.fused_combine(acc, x, op="mac", alpha=float(alpha))


def ring_hop(buf, xs, s: int, *, dim: int, rank_ndim: int, op: str = "add"):
    return _fc.fused_hop(buf, xs, s, dim=dim, rank_ndim=rank_ndim, op=op)


def pack_combine(arena, *parts, op=None):
    return _pc.fused_pack(arena, *parts, op=op)


def topk_accumulate(dense, idx, vals):
    return _ta.topk_accumulate_(dense, idx, vals)


def prefix_sum(x, dim: int = 0):
    return _cs.prefix_sum(x, dim=dim)


def rglru_scan(a, b, h0=None):
    return _cs.rglru_scan(a, b, h0)


def rwkv6_recurrence(r, k, v, w, u, s0=None, *, kv_bf16: bool = False):
    return _rw.rwkv6_recurrence(r, k, v, w, u, s0, kv_bf16=kv_bf16)
