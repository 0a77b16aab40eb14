"""Public wrappers for the hand-written kernels.

Each wrapper is the drop-in, signature-compatible implementation of its
:mod:`repro_torch.kernels.ref` function: on a CUDA tensor it launches the
kernel, on a CPU tensor it runs the plain version.  Only the kernels
ported so far appear here (see ROADMAP.md for the rest).
"""

from __future__ import annotations

from repro_torch.kernels import fused_combine as _fc
from repro_torch.kernels import pack_combine as _pc


def combine_add(x, y):
    return _fc.fused_combine(x, y, op="add")


def combine_max(x, y):
    return _fc.fused_combine(x, y, op="max")


def combine_min(x, y):
    return _fc.fused_combine(x, y, op="min")


def combine_mac(acc, x, alpha: float = 1.0):
    return _fc.fused_combine(acc, x, op="mac", alpha=float(alpha))


def pack_combine(arena, *parts, op=None):
    return _pc.fused_pack(arena, *parts, op=op)
