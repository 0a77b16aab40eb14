"""Sparse (idx, val) scatter-accumulate — CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/topk_accum.py:topk_accumulate``
(body ``_topk_accum_kernel``): ``dense[idx] += vals``, the per-hop combine
of the top-k sparse all-reduce and its decompress
(:mod:`repro_torch.core.compression`).  The rank dims fold into rows:
``dense`` is ``[*rows, size]``, ``idx`` and ``vals`` are ``[*rows, k]``,
and row ``r`` adds into ``dense[r]``.

**In place, deliberately.** The ring's accumulator at acis-100m width is
``[8, 24,576,000]`` f32 (786 MB); an out-of-place add would copy it at
every one of the 8 accumulates per leaf.  So :func:`topk_accumulate_`
updates the accumulator it is given, as its plain version
(``kernels/ref.py::topk_accumulate``) does; the functional form the
reference exposes is :func:`repro_torch.core.compression.sparse_accumulate`,
which clones first.

Bound on the card: device memory — ``rows·k·(4 + 4)`` bytes of payload
read plus ``rows·k·4`` read and written in ``dense`` by the measurement
rule; the card moves 32-byte sectors, so at 1% density nearly every entry
costs a sector read and written back (``chip_smoke.py``'s
``sector_bound_ms``).  The kernel (``csrc/topk_accum.cu``) is one
reduction (``atomicAdd``, result unused) per payload entry on a 2-D grid
of row tiles × rows; the TPU kernel's one-hot MXU matmul is a TPU
workaround and is not carried over.

**One pass.** ``tools/probe_topk.py`` measured what limits the kernel at
the embed leaf: the random read-modify-write of the accumulator's
sectors.  A payload sorted by index (the best any address order gives) is
about 1.1x faster, and a form that first bins the payload by address
window (a counting sort, ``tools/topk_candidates.cu``) is slower, so the
kernel scatters the payload in the order it comes: one launch a call.

Out-of-range indices (negative, or ``>= size``) are dropped, as the
one-hot product drops them; the plain version drops them too.  With
indices distinct within a row (one top-k selection) each lane gets one
add per launch and the kernel equals the plain version bit for bit;
duplicates agree only to f32 rounding, since the atomics' order is the
hardware's.  The kernel takes float32 accumulators and int32 indices and
raises on anything else (bfloat16 included); the plain version takes any
dtype ``index_add_`` takes.

A CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

# kernel launches made by topk_accumulate_ (the main path's proof of use)
launches = 0


def _check(dense: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor):
    if idx.shape != vals.shape or idx.dim() != dense.dim() \
            or idx.shape[:-1] != dense.shape[:-1]:
        raise ValueError(f"expected dense [*rows, size] with idx and vals "
                         f"[*rows, k], got {tuple(dense.shape)}, "
                         f"{tuple(idx.shape)} and {tuple(vals.shape)}")
    if idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise TypeError(f"indices must be integers, got {idx.dtype}")
    if vals.dtype != dense.dtype:
        raise TypeError(f"vals are {vals.dtype}, the accumulator "
                        f"{dense.dtype} (cast the values first)")
    if not dense.is_contiguous():
        raise ValueError("the accumulator must be contiguous (it is "
                         "updated in place)")


def plain(dense: torch.Tensor, idx: torch.Tensor,
          vals: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel: in place, rows folded,
    out-of-range indices dropped."""
    _check(dense, idx, vals)
    return ref.topk_accumulate(dense, idx, vals)


_LIB: Optional[ctypes.CDLL] = None


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/topk_accum.cu``) with its entry point
    typed."""
    lib.acis_topk_accumulate.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p]
    lib.acis_topk_accumulate.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = typed(build.library("topk_accum"))
    return _LIB


def topk_accumulate_(dense: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """``dense[idx] += vals`` row by row, in place; returns ``dense``."""
    global launches
    _check(dense, idx, vals)
    ts = (dense, idx, vals)
    if all(t.device.type == "cpu" for t in ts):
        return plain(dense, idx, vals)
    if dense.device.type != "cuda" or any(t.device != dense.device
                                          for t in ts):
        raise ValueError("topk_accumulate runs on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if dense.dtype != torch.float32:
        raise TypeError(f"topk_accumulate kernel takes float32 "
                        f"accumulators, got {dense.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"topk_accumulate kernel takes int32 indices, got "
                        f"{idx.dtype}")
    if not (idx.is_contiguous() and vals.is_contiguous()):
        raise ValueError("topk_accumulate kernel needs contiguous payloads")
    if idx.numel() == 0:
        return dense
    dev = dense.get_device()
    rc = _lib().acis_topk_accumulate(
        dense.data_ptr(), idx.data_ptr(), vals.data_ptr(),
        math.prod(dense.shape[:-1]), dense.shape[-1], idx.shape[-1], dev,
        build.stream_of(dev))
    launches += 1
    if rc != 0:
        raise RuntimeError(f"topk_accumulate kernel launch failed (code {rc})")
    return dense

