"""Encoded-domain int8 combine (dequant-add-requant) — CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/quant_combine.py:quant_combine``
(body ``_quant_combine_kernel``).  It is the per-hop combine of the
blockwise-int8 wire format (:func:`repro_torch.core.wire.int8_codec`):
two int8 payloads ``[*rows, 256]`` with their f32 scales ``[*rows]`` come
in, one goes out with a fresh per-row absmax scale.  The ring hands it a
chunk of every rank at once (``[*rank, blocks, 256]``); the leading dims
fold into rows, so one launch covers the hop of every rank.

Bound on the card: device memory — 3 × (256 + 4) bytes per row against a
handful of ALU ops per lane.  The kernel (``csrc/quant_combine.cu``) runs
one warp per row with 8-byte loads and a warp-shuffle absmax, so the f32
intermediates never reach device memory.  It rounds exactly as the plain
version does (two rounded products, a rounded sum, IEEE divisions,
round half to even) and so equals it bit for bit.  A row holding a NaN
gets scale 1.0 in both; the kernel writes its NaN lanes as 0.

A CPU tensor goes to the plain version (:mod:`repro_torch.kernels.ref`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

QBLOCK = 256

# kernel launches made by quant_combine (the main path's proof of use)
launches = 0


def plain(qa: torch.Tensor, sa: torch.Tensor, qb: torch.Tensor,
          sb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel."""
    return ref.quant_combine(qa, sa, qb, sb)


def _lib() -> ctypes.CDLL:
    lib = build.library("quant_combine")
    fn = lib.acis_quant_combine
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def quant_combine(qa: torch.Tensor, sa: torch.Tensor, qb: torch.Tensor,
                  sb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Combine two blockwise-int8 payloads: ``q`` is ``[*rows, 256]``
    int8, ``s`` is ``[*rows]`` float32.  Returns ``(q, s)`` of the same
    shapes."""
    global launches
    if qa.shape != qb.shape or qa.dim() < 1 or qa.shape[-1] != QBLOCK:
        raise ValueError(f"payloads must be [*rows, {QBLOCK}] and alike, "
                         f"got {tuple(qa.shape)} and {tuple(qb.shape)}")
    if sa.shape != qa.shape[:-1] or sb.shape != qa.shape[:-1]:
        raise ValueError(f"scales must be {tuple(qa.shape[:-1])}, got "
                         f"{tuple(sa.shape)} and {tuple(sb.shape)}")
    if qa.dtype != torch.int8 or qb.dtype != torch.int8 \
            or sa.dtype != torch.float32 or sb.dtype != torch.float32:
        raise TypeError(f"quant_combine takes int8 payloads and float32 "
                        f"scales, got {qa.dtype}/{sa.dtype} and "
                        f"{qb.dtype}/{sb.dtype}")
    ts = (qa, sa, qb, sb)
    if all(t.device.type == "cpu" for t in ts):
        return plain(qa, sa, qb, sb)
    if qa.device.type != "cuda" or any(t.device != qa.device for t in ts):
        raise ValueError("quant_combine runs on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("quant_combine kernel needs contiguous operands")
    if qa.data_ptr() % 8 or qb.data_ptr() % 8:
        raise ValueError("quant_combine kernel needs 8-byte-aligned payloads")
    qo = torch.empty_like(qa)
    so = torch.empty_like(sa)
    rows = sa.numel()
    if rows == 0:
        return qo, so
    lib = _lib()
    with torch.cuda.device(qa.device):
        rc = lib.acis_quant_combine(
            qa.data_ptr(), sa.data_ptr(), qb.data_ptr(), sb.data_ptr(),
            qo.data_ptr(), so.data_ptr(), rows,
            torch.cuda.current_stream(qa.device).cuda_stream)
    launches += 1
    if rc != 0:
        raise RuntimeError(f"quant_combine kernel launch failed (code {rc})")
    return qo, so
