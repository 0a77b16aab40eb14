"""Per-hop reduce combine (the switch aggregation unit) and the ring
all-gather — CUDA kernels.

Replaces the Pallas kernel ``repro/kernels/fused_combine.py:fused_combine``
(body ``_combine_kernel``).  The hot inner loop of every ACiS reduction
schedule is ``combine(incoming, local)`` on a hop-sized message, in two
forms here:

* :func:`fused_combine` — elementwise over same-shape operands; one launch
  covers the hop of every rank (``[*rank, chunk]``).
* :func:`fused_hop` — one whole step of the ring reduce-scatter of every
  rank: the neighbour's partial sum and the local chunk are read in place
  from the all-ranks tensors by index arithmetic, so the step's roll and
  per-rank gather are never materialised.

Beside them :func:`fused_gather`, the ring all-gather's whole result in
one launch, replaces no TPU kernel (the reference's all-gather is a
``ppermute`` loop): on one card every rank's result is the same
concatenation, so each chunk is read once and written once per rank.

Bound on the card: device memory — 3 × numel × itemsize bytes (read two
operands, write out) against one or two ALU ops per element; the unfused
hop (roll, gather, combine) moves 7 × numel × itemsize.  The kernels
(``csrc/fused_combine.cu``) keep four independent 16-byte loads per
operand in flight per thread, on a grid sized from the occupancy query;
the TPU kernel's 128-lane padding copies and ``[rows, 128]`` reshape have
no counterpart.

A CPU tensor goes to the plain version (:func:`plain`, :func:`hop_plain`,
:func:`gather_plain`); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.obs import metrics as _metrics

OPS = {"add": 0, "max": 1, "min": 2, "mac": 3}
HOP_OPS = ("add", "max", "min")
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# kernel launches made by fused_combine, fused_hop and fused_gather (the
# main path's proof of use)
launches = 0
hop_launches = 0
gather_launches = 0


def plain(x: torch.Tensor, y: torch.Tensor, op: str = "add",
          alpha: float = 1.0) -> torch.Tensor:
    """The plain PyTorch version of the elementwise kernel."""
    if op == "mac":
        return ref.combine_mac(x, y, alpha)
    return ref.COMBINES[op](x, y)


def hop_plain(buf: torch.Tensor, xs: torch.Tensor, s: int, *, dim: int,
              rank_ndim: int, op: str = "add") -> torch.Tensor:
    """The plain PyTorch version of the hop kernel, its formula over the
    ``[A, n, B]`` view of the rank dims (see :func:`fused_hop`)."""
    shape = buf.shape
    n = shape[dim]
    a, b = math.prod(shape[:dim]), math.prod(shape[dim + 1:rank_ndim])
    r = torch.arange(n, device=buf.device)
    incoming = buf.reshape(a, n, b, -1).roll(1, dims=1)
    local = xs.reshape(a, n, b, n, -1)[:, r, :, (r - 2 - s) % n]
    return ref.COMBINES[op](incoming, local.movedim(0, 1)).reshape(shape)


def _gather_view(first: torch.Tensor, dim: int, rank_ndim: int):
    """``(A, n, B, C)``: the rank dims of ``first`` as ``[A, n, B]`` around
    ``dim``, and the elements of one rank's chunk."""
    shape = first.shape
    return (math.prod(shape[:dim]), shape[dim],
            math.prod(shape[dim + 1:rank_ndim]), math.prod(shape[rank_ndim:]))


def gather_plain(first: torch.Tensor, *, dim: int,
                 rank_ndim: int) -> torch.Tensor:
    """The plain PyTorch version of the gather kernel, its formula over the
    ``[A, n, B]`` view of the rank dims (see :func:`fused_gather`)."""
    a, n, b, c = _gather_view(first, dim, rank_ndim)
    every = first.reshape(a, 1, n, b, c).movedim(2, 3)      # [a, 1, b, n, c]
    return every.expand(a, n, b, n, c).contiguous().reshape(
        first.shape[:rank_ndim] + (n,) + first.shape[rank_ndim:])


_LIB: Optional[ctypes.CDLL] = None


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/fused_combine.cu``) with its entry points
    typed."""
    lib.acis_fused_combine.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.acis_fused_combine.restype = ctypes.c_int
    lib.acis_fused_hop.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.acis_fused_hop.restype = ctypes.c_int
    lib.acis_fused_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.acis_fused_gather.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    """The library, its entry points typed once at load."""
    global _LIB
    if _LIB is None:
        _LIB = typed(build.library("fused_combine"))
    return _LIB


@functools.lru_cache(maxsize=64)
def _alpha(alpha: float, dtype: torch.dtype) -> float:
    """``alpha`` rounded to the operands' dtype, as the kernel takes it."""
    return float(torch.tensor(alpha, dtype=dtype))


def _check_pair(x: torch.Tensor, y: torch.Tensor, what: str) -> bool:
    """True for two CPU tensors (the plain version's case); raises for
    what the kernel does not take; False for a kernel launch."""
    if x.dtype != y.dtype:
        raise TypeError(f"dtype mismatch {x.dtype} vs {y.dtype}")
    if x.is_cpu and y.is_cpu:
        return True
    if not x.is_cuda or y.get_device() != x.get_device():
        raise ValueError(f"{what} runs on one CUDA device, got "
                         f"{x.device} and {y.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{what} kernel takes {list(DTYPES)}, got {x.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous operands")
    return False


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
    if _check_pair(x, y, "fused_combine"):
        return plain(x, y, op, alpha)
    if op == "mac" and not x.dtype.is_floating_point:
        raise TypeError("mac is defined for float32/bfloat16 only")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    a = _alpha(alpha, x.dtype) if op == "mac" else 1.0
    rc = _lib().acis_fused_combine(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
        DTYPES[x.dtype], OPS[op], a, x.get_device(),
        build.stream_of(x.get_device()))
    launches += 1
    if rc != 0:
        raise RuntimeError(f"fused_combine kernel launch failed (code {rc})")
    return out


def fused_hop(buf: torch.Tensor, xs: torch.Tensor, s: int, *, dim: int,
              rank_ndim: int, op: str = "add") -> torch.Tensor:
    """Step ``s`` of the ring reduce-scatter over rank dim ``dim``, every
    rank at once: with the rank dims viewed as ``[A, n, B]``,

        out[a, r, b] = combine(buf[a, (r - 1) % n, b],
                               xs[a, r, b, (r - 2 - s) % n])

    ``buf`` is ``[*rank, *chunk]`` (each rank's running partial sum),
    ``xs`` is ``[*rank, n, *chunk]`` (each rank's input in ``n`` ring
    chunks), ``0 <= s <= n - 2``; ``op`` in {add, max, min}.  It is
    ``combine(tp.shift(buf, 1), tp.take(xs, (i - 2 - s) % n))`` on a
    :class:`~repro_torch.mesh.LocalMesh`, in one launch.

    The least bytes a launch moves are 3 × ``buf.nbytes``: each output
    row reads its sender's row of ``buf`` and one ring chunk of ``xs``
    (both the row's size) and writes the row (``hop_kernel``).  While
    spans are recorded each launch adds them to the counter
    ``kernel.fused_hop.bytes``."""
    global hop_launches
    if op not in HOP_OPS:
        raise ValueError(f"unknown hop op {op!r}; expected {list(HOP_OPS)}")
    if not 0 <= dim < rank_ndim:
        raise ValueError(f"ring dim {dim} is not one of {rank_ndim} rank dims")
    n = buf.shape[dim]
    if xs.shape != buf.shape[:rank_ndim] + (n,) + buf.shape[rank_ndim:]:
        raise ValueError(f"xs {tuple(xs.shape)} is not buf "
                         f"{tuple(buf.shape)} split in {n} ring chunks")
    if not 0 <= s <= n - 2:
        raise ValueError(f"hop {s} of a ring of {n}")
    if _check_pair(buf, xs, "fused_hop"):
        return hop_plain(buf, xs, s, dim=dim, rank_ndim=rank_ndim, op=op)
    out = torch.empty_like(buf)
    if out.numel() == 0:
        return out
    shape = buf.shape
    rc = _lib().acis_fused_hop(
        buf.data_ptr(), xs.data_ptr(), out.data_ptr(),
        math.prod(shape[:dim]), n, math.prod(shape[dim + 1:rank_ndim]),
        math.prod(shape[rank_ndim:]), s, DTYPES[buf.dtype], OPS[op],
        buf.get_device(), build.stream_of(buf.get_device()))
    hop_launches += 1
    if rc != 0:
        raise RuntimeError(f"fused_hop kernel launch failed (code {rc})")
    rec = _metrics.RECORDER
    if rec.spans is not None:
        rec.count("kernel.fused_hop.bytes", 3 * buf.nbytes)
    return out


def fused_gather(first: torch.Tensor, *, dim: int,
                 rank_ndim: int) -> torch.Tensor:
    """The ring all-gather over rank dim ``dim``, every rank at once: with
    the rank dims viewed as ``[A, n, B]``,

        out[a, r, b, j] = first[a, j, b]        for every r in 0..n-1

    ``first`` is ``[*rank, *chunk]`` (each rank's chunk), the result
    ``[*rank, n, *chunk]``: every rank holds every rank's chunk in rank
    order, which is what the ring's n - 1 shifts and puts leave on a
    :class:`~repro_torch.mesh.LocalMesh`, bit for bit.  The kernel copies
    bytes, so any dtype goes.

    The least bytes a launch moves are (1 + n) × ``first.nbytes``: each
    chunk is read once and written into each of the n ranks' results
    (``gather_kernel``).

    The kernel's result carries no gradient, so a CUDA ``first`` that
    requires one, while autograd records, is refused; the plain version
    on the CPU is differentiable."""
    global gather_launches
    if not 0 <= dim < rank_ndim <= first.dim():
        raise ValueError(f"ring dim {dim} is not one of {rank_ndim} rank "
                         f"dims of a {first.dim()}-d tensor")
    if first.is_cpu:
        return gather_plain(first, dim=dim, rank_ndim=rank_ndim)
    if not first.is_cuda:
        raise ValueError(f"fused_gather runs on a CUDA device, got "
                         f"{first.device}")
    if torch.is_grad_enabled() and first.requires_grad:
        raise RuntimeError("fused_gather has no backward: gather a CUDA "
                           "tensor that requires grad under torch.no_grad()")
    if not first.is_contiguous():
        raise ValueError("fused_gather kernel needs a contiguous operand")
    a, n, b, c = _gather_view(first, dim, rank_ndim)
    out = first.new_empty(first.shape[:rank_ndim] + (n,)
                          + first.shape[rank_ndim:])
    if out.numel() == 0:
        return out
    rc = _lib().acis_fused_gather(
        first.data_ptr(), out.data_ptr(), a, n, b, c * first.element_size(),
        first.get_device(), build.stream_of(first.get_device()))
    gather_launches += 1
    if rc != 0:
        raise RuntimeError(f"fused_gather kernel launch failed (code {rc})")
    return out
