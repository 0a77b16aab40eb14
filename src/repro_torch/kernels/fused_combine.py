"""Per-hop reduce combine (the switch aggregation unit) — CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/fused_combine.py:fused_combine``
(body ``_combine_kernel``).  The hot inner loop of every ACiS reduction
schedule is ``combine(incoming, local)`` on a hop-sized message; one
launch covers the hop of every rank (``[*rank, chunk]``).

Bound on the card: device memory — 3 × numel × itemsize bytes (read x and
y, write out) against one or two ALU ops per element.  The kernel
(``csrc/fused_combine.cu``) is one grid-stride pass of 16-byte vector
loads over the contiguous operands with a scalar tail, so it moves each
byte once; the TPU kernel's 128-lane padding copies and ``[rows, 128]``
reshape have no counterpart.

A CPU tensor goes to the plain version (:mod:`repro_torch.kernels.ref`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

OPS = {"add": 0, "max": 1, "min": 2, "mac": 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# kernel launches made by fused_combine (the main path's proof of use)
launches = 0


def plain(x: torch.Tensor, y: torch.Tensor, op: str = "add",
          alpha: float = 1.0) -> torch.Tensor:
    """The plain PyTorch version of the kernel."""
    if op == "mac":
        return ref.combine_mac(x, y, alpha)
    return {"add": ref.combine_add, "max": ref.combine_max,
            "min": ref.combine_min}[op](x, y)


def _lib() -> ctypes.CDLL:
    lib = build.library("fused_combine")
    fn = lib.acis_fused_combine
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def fused_combine(x: torch.Tensor, y: torch.Tensor, *, op: str = "add",
                  alpha: float = 1.0) -> torch.Tensor:
    """``combine(x, y)`` elementwise over same-shape operands:
    ``add`` | ``max`` | ``min`` (NaN-propagating) | ``mac`` = ``x +
    alpha * y`` with ``alpha`` cast to the operands' dtype."""
    global launches
    if op not in OPS:
        raise ValueError(f"unknown combine op {op!r}; expected {sorted(OPS)}")
    if x.shape != y.shape:
        raise ValueError(f"shape mismatch {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    if x.dtype != y.dtype:
        raise TypeError(f"dtype mismatch {x.dtype} vs {y.dtype}")
    if x.device.type == "cpu" and y.device.type == "cpu":
        return plain(x, y, op, alpha)
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"fused_combine runs on one CUDA device, got "
                         f"{x.device} and {y.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"fused_combine kernel takes {list(DTYPES)}, "
                        f"got {x.dtype}")
    if op == "mac" and not x.dtype.is_floating_point:
        raise TypeError("mac is defined for float32/bfloat16 only")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("fused_combine kernel needs contiguous operands")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    # alpha enters the kernel already rounded to the operands' dtype
    a = float(torch.tensor(alpha, dtype=x.dtype)) if op == "mac" else 1.0
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.acis_fused_combine(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
            DTYPES[x.dtype], OPS[op], a,
            torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    if rc != 0:
        raise RuntimeError(f"fused_combine kernel launch failed (code {rc})")
    return out
