"""Encoded-domain int8 combine (dequant-add-requant) — CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/quant_combine.py:quant_combine``
(body ``_quant_combine_kernel``).  It is the per-hop combine of the
blockwise-int8 wire format (:func:`repro_torch.core.wire.int8_codec`):
two int8 payloads ``[*rows, 256]`` with their f32 scales ``[*rows]`` come
in, one goes out with a fresh per-row absmax scale.  Two forms:

* :func:`quant_combine` — over same-shape operands; the leading dims fold
  into rows, so one launch covers the hop of every rank.
* :func:`quant_hop` — one whole step of the encoded ring reduce-scatter
  of every rank: the neighbour's partial sum and the local chunk are read
  in place from the all-ranks tensors, so the step's roll and per-rank
  gather of payload and scales are never materialised.

Bound on the card: device memory — 3 × (256 + 4) bytes per row against a
handful of ALU ops per lane; the unfused hop (roll, gather, combine)
moves 7 × (256 + 4).  The kernels (``csrc/quant_combine.cu``) give each
row a half-warp with 16-byte loads, several rows in flight per warp, and
divide once per row, not per lane, so the f32 intermediates never reach
device memory.  They round exactly as the plain version does (two rounded
products, a rounded sum, the IEEE quotient's round half to even) and so
equal it bit for bit.  A row holding a NaN gets scale 1.0 in both; the
kernels write its NaN lanes as 0.

A CPU tensor goes to the plain version (:mod:`repro_torch.kernels.ref`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

QBLOCK = 256

# kernel launches made by quant_combine and quant_hop (the main path's
# proof of use)
launches = 0
hop_launches = 0


def plain(qa: torch.Tensor, sa: torch.Tensor, qb: torch.Tensor,
          sb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the elementwise kernel."""
    return ref.quant_combine(qa, sa, qb, sb)


def hop_plain(q_buf: torch.Tensor, s_buf: torch.Tensor, q_xs: torch.Tensor,
              s_xs: torch.Tensor, s: int, *, dim: int, rank_ndim: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the hop kernel, its formula over the
    ``[A, n, B]`` view of the rank dims (see :func:`quant_hop`)."""
    shape = s_buf.shape
    n = shape[dim]
    a, b = math.prod(shape[:dim]), math.prod(shape[dim + 1:rank_ndim])
    r = torch.arange(n, device=s_buf.device)
    c = (r - 2 - s) % n

    def incoming(t):
        return t.reshape((a, n, b) + tuple(t.shape[rank_ndim:])).roll(1, 1)

    def local(t):
        t = t.reshape((a, n, b, n) + tuple(t.shape[rank_ndim + 1:]))
        return t[:, r, :, c].movedim(0, 1)

    q, sc = ref.quant_combine(incoming(q_buf), incoming(s_buf),
                              local(q_xs), local(s_xs))
    return q.reshape(q_buf.shape), sc.reshape(shape)


_LIB: Optional[ctypes.CDLL] = None


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/quant_combine.cu``) with its entry
    points typed."""
    lib.acis_quant_combine.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.acis_quant_combine.restype = ctypes.c_int
    lib.acis_quant_hop.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.acis_quant_hop.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    """The library, its entry points typed once at load."""
    global _LIB
    if _LIB is None:
        _LIB = typed(build.library("quant_combine"))
    return _LIB


def _check(what: str, q0, s0, q1, s1) -> bool:
    """True for CPU operands (the plain version's case); raises for what
    the kernel does not take; False for a kernel launch.  Written for the
    per-hop host path: no generators and no device objects."""
    if q0.dtype is not torch.int8 or q1.dtype is not torch.int8 \
            or s0.dtype is not torch.float32 or s1.dtype is not torch.float32:
        raise TypeError(f"{what} takes int8 payloads and float32 scales, "
                        f"got {q0.dtype}/{s0.dtype} and {q1.dtype}/{s1.dtype}")
    if q0.is_cpu and s0.is_cpu and q1.is_cpu and s1.is_cpu:
        return True
    dev = q0.get_device()
    if not q0.is_cuda or not dev == s0.get_device() == q1.get_device() \
            == s1.get_device():
        raise ValueError(f"{what} runs on one CUDA device, got "
                         f"{[str(t.device) for t in (q0, s0, q1, s1)]}")
    if not (q0.is_contiguous() and s0.is_contiguous() and q1.is_contiguous()
            and s1.is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous operands")
    if (q0.data_ptr() | q1.data_ptr()) % 16:
        raise ValueError(f"{what} kernel needs 16-byte-aligned payloads")
    return False


def quant_combine(qa: torch.Tensor, sa: torch.Tensor, qb: torch.Tensor,
                  sb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Combine two blockwise-int8 payloads: ``q`` is ``[*rows, 256]``
    int8, ``s`` is ``[*rows]`` float32.  Returns ``(q, s)`` of the same
    shapes."""
    global launches
    shape, rows = tuple(qa.shape), tuple(sa.shape)
    if tuple(qb.shape) != shape or shape[-1:] != (QBLOCK,):
        raise ValueError(f"payloads must be [*rows, {QBLOCK}] and alike, "
                         f"got {shape} and {tuple(qb.shape)}")
    if rows != shape[:-1] or tuple(sb.shape) != rows:
        raise ValueError(f"scales must be {shape[:-1]}, got {rows} and "
                         f"{tuple(sb.shape)}")
    if _check("quant_combine", qa, sa, qb, sb):
        return plain(qa, sa, qb, sb)
    qo = torch.empty_like(qa)
    so = torch.empty_like(sa)
    if sa.numel() == 0:
        return qo, so
    dev = qa.get_device()
    rc = _lib().acis_quant_combine(
        qa.data_ptr(), sa.data_ptr(), qb.data_ptr(), sb.data_ptr(),
        qo.data_ptr(), so.data_ptr(), so.numel(), dev, build.stream_of(dev))
    launches += 1
    if rc != 0:
        raise RuntimeError(f"quant_combine kernel launch failed (code {rc})")
    return qo, so


def quant_hop(q_buf: torch.Tensor, s_buf: torch.Tensor, q_xs: torch.Tensor,
              s_xs: torch.Tensor, s: int, *, dim: int, rank_ndim: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Step ``s`` of the encoded ring reduce-scatter over rank dim
    ``dim``, every rank at once: with the rank dims viewed as ``[A, n,
    B]``,

        (q, s)[a, r, b] = quant_combine(buf[a, (r - 1) % n, b],
                                        xs[a, r, b, (r - 2 - s) % n])

    ``q_buf`` is ``[*rank, rows, 256]`` int8 and ``s_buf`` ``[*rank,
    rows]`` float32 (each rank's running partial sum); ``q_xs`` and
    ``s_xs`` are ``[*rank, n, rows, 256]`` and ``[*rank, n, rows]`` (each
    rank's input in ``n`` ring chunks); ``0 <= s <= n - 2``.  It is
    ``quant_combine(shift(buf, 1), take(xs, (i - 2 - s) % n))`` on a
    :class:`~repro_torch.mesh.LocalMesh`, in one launch."""
    global hop_launches
    if not 0 <= dim < rank_ndim:
        raise ValueError(f"ring dim {dim} is not one of {rank_ndim} rank dims")
    sb, sx = tuple(s_buf.shape), tuple(s_xs.shape)
    if len(sb) != rank_ndim + 1 or tuple(q_buf.shape) != sb + (QBLOCK,):
        raise ValueError(f"buf must be [*rank, rows, {QBLOCK}] and [*rank, "
                         f"rows], got {tuple(q_buf.shape)} and {sb}")
    n, rank, rows = sb[dim], sb[:rank_ndim], sb[rank_ndim]
    if sx != rank + (n, rows) or tuple(q_xs.shape) != sx + (QBLOCK,):
        raise ValueError(f"xs {tuple(q_xs.shape)} / {sx} is not buf split "
                         f"in {n} ring chunks")
    if not 0 <= s <= n - 2:
        raise ValueError(f"hop {s} of a ring of {n}")
    if _check("quant_hop", q_buf, s_buf, q_xs, s_xs):
        return hop_plain(q_buf, s_buf, q_xs, s_xs, s, dim=dim,
                         rank_ndim=rank_ndim)
    q_out = torch.empty_like(q_buf)
    s_out = torch.empty_like(s_buf)
    if s_out.numel() == 0:
        return q_out, s_out
    dev = q_buf.get_device()
    rc = _lib().acis_quant_hop(
        q_buf.data_ptr(), s_buf.data_ptr(), q_xs.data_ptr(), s_xs.data_ptr(),
        q_out.data_ptr(), s_out.data_ptr(), math.prod(rank[:dim]), n,
        math.prod(rank[dim + 1:]), rows, s, dev, build.stream_of(dev))
    hop_launches += 1
    if rc != 0:
        raise RuntimeError(f"quant_hop kernel launch failed (code {rc})")
    return q_out, s_out
