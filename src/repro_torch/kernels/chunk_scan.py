"""Inclusive prefix sum along one dim — CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/chunk_scan.py:prefix_sum``
(body ``_prefix_kernel``): the Fig. 5 scan op (switchops ``prefix_sum``),
which :func:`repro_torch.core.lookaside.distributed_prefix_sum` runs as
the local scan of every inclusive-add ``scan+allgather`` stage.  The port
scans any dim: ``prefix_sum(x, dim)`` views ``x`` as ``[B, T, D]`` — the
dims before ``dim`` are batch (the rank dims, on the fused path), the
dims after it lanes — so one launch scans the local block of every rank.
The reference's ``rglru_scan`` (same module) waits for the models slice.

Bound on the card: device memory — ``x`` read once and the result written
once.  The kernel (``csrc/prefix_sum.cu``) is reduce-then-scan over tiles
of about 4,096 elements (tile totals, a scan of the totals per column,
then each tile scanned again with its carry-in): it reads ``x`` twice and
writes once, with 16-byte loads where a thread's rows are contiguous
(``D == 1``).  The TPU kernel's sequential 256-row grid with a VMEM carry
has no counterpart: blocks on the card run in parallel.

Numbers: float32 and bfloat16, accumulated in f32, each output rounded
once to ``x``'s dtype; other dtypes raise.  The summation order is the
kernel's own, so it equals the plain version (``torch.cumsum``) bit for
bit only where every partial sum is exact (integer-valued f32 data below
2^24), and within rounding elsewhere.

A CPU tensor goes to the plain version (:mod:`repro_torch.kernels.ref`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

THREADS, ROWS = 256, 16          # csrc/prefix_sum.cu: kThreads, kRows
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by prefix_sum (the main path's proof of use)
launches = 0


def layout(shape, dim: int) -> tuple[int, int, int, int, int]:
    """``(B, T, D, lanes per block, tiles)`` of the kernel's launch for a
    tensor of ``shape`` scanned along ``dim``: a block covers up to 32
    lanes and ``(256 / lanes) * 16`` rows (4,096 elements)."""
    b = math.prod(shape[:dim])
    t = shape[dim]
    d = math.prod(shape[dim + 1:])
    lb = min(32, 1 << max(d - 1, 0).bit_length())
    return b, t, d, lb, max(1, -(-t // (THREADS // lb * ROWS)))


def _dim(x: torch.Tensor, dim: int) -> int:
    if x.dim() == 0:
        raise ValueError("prefix_sum needs at least one dim to scan")
    if not -x.dim() <= dim < x.dim():
        raise IndexError(f"dim {dim} out of range for a {x.dim()}-d tensor")
    return dim % x.dim()


def plain(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The plain PyTorch version of the kernel."""
    return ref.prefix_sum(x, dim=_dim(x, dim))


def _lib() -> ctypes.CDLL:
    lib = build.library("prefix_sum")
    fn = lib.acis_prefix_sum
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 \
        + [ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def prefix_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inclusive prefix sum of ``x`` along ``dim``, in ``x``'s dtype."""
    global launches
    dim = _dim(x, dim)
    if x.device.type == "cpu":
        return plain(x, dim)
    if x.device.type != "cuda":
        raise ValueError(f"prefix_sum runs on a CUDA device, got {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"prefix_sum kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("prefix_sum kernel needs a contiguous tensor")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b, t, d, lb, tiles = layout(tuple(x.shape), dim)
    carry = torch.empty((b * d * tiles if tiles > 1 else 0,),
                        dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.acis_prefix_sum(
            x.data_ptr(), out.data_ptr(), carry.data_ptr() if tiles > 1
            else None, b, t, d, lb, tiles, DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    if rc != 0:
        raise RuntimeError(f"prefix_sum kernel launch failed (code {rc})")
    return out
