"""Fused bucket pack (+ optional combine) into an arena — CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/pack_combine.py:fused_pack``
(body ``_pack_kernel``).  The Coalesce pass packs N gradient leaves into
one flat bucket before the ring collective; with a persistent arena the
whole pack is ONE launch that writes every leaf into the arena tensor
itself (``data_ptr()`` unchanged).  ``op`` additionally combines each
leaf into the arena's current segment (``add``/``max``/``min``,
NaN-propagating).

Bound on the card: device memory — 2 × Σsᵢ × rows × itemsize bytes for
the pure pack (read each part, write its segment), 3× with ``op``.  The
kernel (``csrc/fused_pack.cu``) folds the rank dims into rows and is
driven by a small device table of (part pointer, segment offset, size,
first block): each block finds its part by binary search and copies one
element range.  Lanes past Σsᵢ are never touched — the TPU kernel's
whole-arena carry copy is not needed when the kernel writes the arena
itself.

A CPU arena goes to the plain version (:mod:`repro_torch.kernels.ref`);
a CUDA arena launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fused_combine import DTYPES

OPS = {None: -1, "add": 0, "max": 1, "min": 2}
PER_BLOCK = 4096            # elements one block copies

# kernel launches made by fused_pack (the main path's proof of use)
launches = 0


def plain(arena: torch.Tensor, *parts: torch.Tensor,
          op: Optional[str] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel (also in place)."""
    return ref.pack_combine(arena, *parts, op=op)


def _lib() -> ctypes.CDLL:
    lib = build.library("fused_pack")
    fn = lib.acis_fused_pack
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


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
    rows = tuple(arena.shape[:-1])
    sizes = []
    for i, p in enumerate(parts):
        if tuple(p.shape[:-1]) != rows:
            raise ValueError(f"part {i} is {tuple(p.shape)}, expected "
                             f"[{', '.join(map(str, rows))}, size]")
        if p.dtype != arena.dtype:
            raise TypeError(f"part {i} is {p.dtype}, the arena "
                            f"{arena.dtype} (cast the parts first)")
        sizes.append(int(p.shape[-1]))
    if sum(sizes) > arena.shape[-1]:
        raise ValueError(f"pack of {sum(sizes)} elements overflows arena of "
                         f"{arena.shape[-1]}")
    if arena.device.type == "cpu" and all(p.device.type == "cpu"
                                           for p in parts):
        return plain(arena, *parts, op=op)
    if arena.device.type != "cuda" or any(p.device != arena.device
                                          for p in parts):
        raise ValueError("fused_pack runs on one CUDA device")
    if arena.dtype not in DTYPES:
        raise TypeError(f"fused_pack kernel takes {list(DTYPES)}, "
                        f"got {arena.dtype}")
    if not arena.is_contiguous() or not all(p.is_contiguous()
                                            for p in parts):
        raise ValueError("fused_pack kernel needs contiguous arena and parts")
    n_rows = math.prod(rows)
    table, block0, off = [], 0, 0
    for p, s in zip(parts, sizes):
        if s and n_rows:
            table.append((p.data_ptr(), off, s, block0))
            block0 += -(-s * n_rows // PER_BLOCK)
        off += s
    if not table:
        return arena
    dev_table = torch.tensor(table, dtype=torch.int64).to(arena.device)
    lib = _lib()
    with torch.cuda.device(arena.device):
        rc = lib.acis_fused_pack(
            arena.data_ptr(), dev_table.data_ptr(), len(table), n_rows,
            arena.shape[-1], block0, PER_BLOCK, DTYPES[arena.dtype],
            OPS[op], torch.cuda.current_stream(arena.device).cuda_stream)
    launches += 1
    if rc != 0:
        raise RuntimeError(f"fused_pack kernel launch failed (code {rc})")
    return arena
