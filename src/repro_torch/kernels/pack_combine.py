"""Fused bucket pack (+ optional combine) into an arena — CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/pack_combine.py:fused_pack``
(body ``_pack_kernel``).  The Coalesce pass packs N gradient leaves into
one flat bucket before the ring collective; with a persistent arena the
whole pack is ONE launch that writes every leaf into the arena tensor
itself (``data_ptr()`` unchanged).  ``op`` additionally combines each
leaf into the arena's current segment (``add``/``max``/``min``,
NaN-propagating).

Bound on the card: device memory — 2 × Σsᵢ × rows × itemsize bytes for
the pure pack (read each part, write its segment), 3× with ``op``; at a
bucket's size, the launch.  The kernel (``csrc/fused_pack.cu``) takes the
part table by value in its parameter (at most :data:`MAX_PARTS` parts a
launch, :func:`pack_plan`, built here with no tensor and no upload),
runs a 2-D grid of column tiles × rows, and copies one 16-byte vector per
thread per tile where alignment allows.  Lanes past Σsᵢ are
never touched — the TPU kernel's whole-arena carry copy is not needed
when the kernel writes the arena itself.

A CPU arena goes to the plain version (:mod:`repro_torch.kernels.ref`);
a CUDA arena launches the kernel or raises.
"""

from __future__ import annotations

import array
import ctypes
import math
from typing import Optional, Sequence

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fused_combine import DTYPES

OPS = {None: -1, "add": 0, "max": 1, "min": 2}
MAX_PARTS = 96              # parts one launch's parameter holds
THREADS = 256               # threads of a block, one 16-byte vector each

# kernel launches made by fused_pack (the main path's proof of use)
launches = 0


def tile_elems(itemsize: int) -> int:
    """Columns of one part a block covers: a 16-byte vector per thread."""
    return THREADS * (16 // itemsize)


def pack_plan(ptrs: Sequence[int], sizes: Sequence[int],
              itemsize: int) -> list[tuple[list, list, list, list]]:
    """The launches of a pack, each ``(src, offset, size, tile0)`` of at
    most :data:`MAX_PARTS` parts: parts of size 0 left out, the rest in
    order, each segment at the sum of the sizes before it, ``tile0`` the
    prefix of the parts' tile counts (its last entry the launch's
    blocks per row).  The kernel's by-value parameter is these lists."""
    tile = tile_elems(itemsize)
    plan: list = []
    src = None
    off = 0
    for ptr, size in zip(ptrs, sizes):
        if size:
            if src is None or len(src) == MAX_PARTS:
                src, offset, size_, tile0 = [], [], [], [0]
                plan.append((src, offset, size_, tile0))
            src.append(ptr)
            offset.append(off)
            size_.append(size)
            tile0.append(tile0[-1] + -(-size // tile))
        off += size
    return plan


def plain(arena: torch.Tensor, *parts: torch.Tensor,
          op: Optional[str] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel (also in place)."""
    return ref.pack_combine(arena, *parts, op=op)


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The library, its entry point typed once at load."""
    global _LIB
    if _LIB is None:
        lib = build.library("fused_pack")
        if lib.acis_fused_pack_max_parts() != MAX_PARTS:
            raise RuntimeError("fused_pack.cu and its wrapper disagree on "
                               "the parts one launch holds")
        lib.acis_fused_pack.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.acis_fused_pack.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _bad_parts(arena: torch.Tensor, parts) -> Exception:
    """The error for the first part the kernel and its plain version do
    not take (device and layout are the kernel's own conditions)."""
    rows = tuple(arena.shape[:-1])
    for i, p in enumerate(parts):
        if tuple(p.shape[:-1]) != rows:
            return ValueError(f"part {i} is {tuple(p.shape)}, expected "
                              f"[{', '.join(map(str, rows))}, size]")
        if p.dtype != arena.dtype:
            return TypeError(f"part {i} is {p.dtype}, the arena "
                             f"{arena.dtype} (cast the parts first)")
    if not (arena.is_cuda and all(p.device == arena.device for p in parts)):
        return ValueError("fused_pack runs on one CUDA device")
    if arena.dtype not in DTYPES:
        return TypeError(f"fused_pack kernel takes {list(DTYPES)}, "
                         f"got {arena.dtype}")
    return ValueError("fused_pack kernel needs contiguous arena and parts")


def fused_pack(arena: torch.Tensor, *parts: torch.Tensor,
               op: Optional[str] = None) -> torch.Tensor:
    """Write ``parts`` back to back into ``arena`` in place and return it.

    ``arena`` is ``[*rows, A]`` (the rank dims are the rows); part ``i``
    is ``[*rows, sᵢ]``, already cast to the arena's dtype.  ``op=None`` is
    the pure pack; ``op`` in {add, max, min} combines each part into its
    segment instead.  A pack with Σsᵢ > A raises ``ValueError`` before
    anything is written.
    """
    global launches
    if op not in OPS:
        raise ValueError(f"unknown pack op {op!r}; expected "
                         f"{[k for k in OPS if k]} or None")
    if not parts:
        return arena
    # one pass of cheap checks; the exact error comes from _bad_parts
    shape, dt = arena.shape, arena.dtype
    rows, cuda = shape[:-1], arena.is_cuda
    dev = arena.get_device()
    sizes, ptrs = [], []
    for p in parts:
        ps = p.shape
        if ps[:-1] != rows or p.dtype != dt:
            raise _bad_parts(arena, parts)
        if cuda:
            if p.get_device() != dev or not p.is_contiguous():
                raise _bad_parts(arena, parts)
            ptrs.append(p.data_ptr())
        sizes.append(ps[-1])
    if sum(sizes) > shape[-1]:
        raise ValueError(f"pack of {sum(sizes)} elements overflows arena of "
                         f"{shape[-1]}")
    if not cuda:
        if arena.is_cpu and all(p.is_cpu for p in parts):
            return plain(arena, *parts, op=op)
        raise _bad_parts(arena, parts)
    if dt not in DTYPES or not arena.is_contiguous():
        raise _bad_parts(arena, parts)
    n_rows = math.prod(rows)
    if not n_rows:
        return arena
    lib, stream = _lib(), build.stream_of(dev)
    for src, offset, size, tile0 in pack_plan(ptrs, sizes,
                                              arena.element_size()):
        table = array.array("q", src + offset + size + tile0)
        rc = lib.acis_fused_pack(
            arena.data_ptr(), shape[-1], n_rows, len(src),
            table.buffer_info()[0], DTYPES[dt], OPS[op], dev, stream)
        launches += 1
        if rc != 0:
            raise RuntimeError(f"fused_pack kernel launch failed (code {rc})")
    return arena
