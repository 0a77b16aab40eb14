"""The two chunked scans of the reference's module — CUDA kernels.

**prefix_sum**, an inclusive prefix sum along one dim, replaces the Pallas
kernel ``repro/kernels/chunk_scan.py:prefix_sum`` (body
``_prefix_kernel``): the Fig. 5 scan op (switchops ``prefix_sum``),
which :func:`repro_torch.core.lookaside.distributed_prefix_sum` runs as
the local scan of every inclusive-add ``scan+allgather`` stage.  The port
scans any dim: ``prefix_sum(x, dim)`` views ``x`` as ``[B, T, D]`` — the
dims before ``dim`` are batch (the rank dims, on the fused path), the
dims after it lanes — so one launch scans the local block of every rank.
**rglru_scan** (below, after prefix_sum) computes the RG-LRU recurrence of
the hybrid family's serving path.

Bound on the card: device memory — ``x`` read once and the result written
once.  The kernel (``csrc/prefix_sum.cu``) is a single-pass chained scan
with decoupled look-back, one launch: each block takes a tile of about
8,192 elements from an atomic counter, reads it once, publishes its
total, adds its predecessors' published totals back to the first
inclusive prefix for its carry-in, and writes the tile once, with
16-byte loads, a warp's 512 contiguous bytes at a time, where the
scanned dim is the last (``D == 1``).  The
status words and the counter live in one scratch tensor the wrapper
zeroes (:func:`scratch_words`).  The TPU kernel's sequential 256-row
grid with a VMEM carry has no counterpart: blocks on the card run in
parallel.

Numbers: float32 and bfloat16, accumulated in f32, each output rounded
once to ``x``'s dtype; other dtypes raise.  The summation order is the
kernel's own, and a tile's carry-in sums its predecessors' totals back to
whichever inclusive prefix had been published when it looked, so the
last bits of a float result may differ between two runs on the same
input.  It equals the plain version (``torch.cumsum``) bit for bit only
where every partial sum is exact (integer-valued f32 data below 2^24),
and is within rounding elsewhere.

A CPU tensor goes to the plain version (:mod:`repro_torch.kernels.ref`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

THREADS, ROWS = 256, 32          # csrc/prefix_sum.cu: kThreads, kRows
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches made by prefix_sum (the main path's proof of use)
launches = 0


def layout(shape, dim: int) -> tuple[int, int, int, int, int]:
    """``(B, T, D, lanes per block, tiles)`` of the kernel's launch for a
    tensor of ``shape`` scanned along ``dim``: a block covers up to 32
    lanes and ``(256 / lanes) * 32`` rows (8,192 elements)."""
    b = math.prod(shape[:dim])
    t = shape[dim]
    d = math.prod(shape[dim + 1:])
    lb = min(32, 1 << max(d - 1, 0).bit_length())
    return b, t, d, lb, max(1, -(-t // (THREADS // lb * ROWS)))


def scratch_words(shape, dim: int) -> int:
    """8-byte words of the kernel's zeroed scratch for a tensor of
    ``shape`` scanned along ``dim``: one status word per lane of every
    tile of every chain (a ``b`` and a block's run of lanes), then the
    tile counter; none when a chain is one tile (no look-back)."""
    return _words(*layout(shape, dim))


def _words(b: int, t: int, d: int, lb: int, tiles: int) -> int:
    return b * -(-d // lb) * tiles * lb + 1 if tiles > 1 else 0


def _dim(x: torch.Tensor, dim: int) -> int:
    if x.dim() == 0:
        raise ValueError("prefix_sum needs at least one dim to scan")
    if not -x.dim() <= dim < x.dim():
        raise IndexError(f"dim {dim} out of range for a {x.dim()}-d tensor")
    return dim % x.dim()


def plain(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The plain PyTorch version of the kernel."""
    return ref.prefix_sum(x, dim=_dim(x, dim))


_LIB: Optional[ctypes.CDLL] = None


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/prefix_sum.cu``) with its entry point
    typed."""
    lib.acis_prefix_sum.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]
    lib.acis_prefix_sum.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    """The library, its entry point typed once at load."""
    global _LIB
    if _LIB is None:
        _LIB = typed(build.library("prefix_sum"))
    return _LIB


def prefix_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inclusive prefix sum of ``x`` along ``dim``, in ``x``'s dtype."""
    global launches
    dim = _dim(x, dim)
    if x.is_cpu:
        return plain(x, dim)
    if not x.is_cuda:
        raise ValueError(f"prefix_sum runs on a CUDA device, got {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"prefix_sum kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("prefix_sum kernel needs a contiguous tensor")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b, t, d, lb, tiles = lay = layout(tuple(x.shape), dim)
    words = _words(*lay)
    status = torch.zeros((words,), dtype=torch.int64, device=x.device) \
        if words else None
    dev = x.get_device()
    rc = _lib().acis_prefix_sum(
        x.data_ptr(), out.data_ptr(),
        None if status is None else status.data_ptr(), b, t, d, lb, tiles,
        DTYPES[x.dtype], dev, build.stream_of(dev))
    launches += 1
    if rc != 0:
        raise RuntimeError(f"prefix_sum kernel launch failed (code {rc})")
    return out


# ---------------------------------------------------------------------------
# rglru_scan — the RG-LRU recurrence  h_t = a_t * h_{t-1} + b_t
# ---------------------------------------------------------------------------
#
# Replaces the Pallas kernel ``repro/kernels/chunk_scan.py:rglru_scan``
# (body ``_rglru_kernel``), which the reference never calls: its RG-LRU
# decode steps ``h = a*h + b`` in jnp and its prefill runs T decode steps.
# In the port :func:`repro_torch.models.rglru.rglru_prefill` launches it
# once per layer over the whole prompt, and ``rglru_decode`` (T = 1) once
# per layer per decode step.
#
# ``rglru_scan(a, b, h0=None, *, h_out=None)`` takes a, b ``[..., T, D]``
# (leading dims batch, D lanes; float32 or bfloat16, one dtype) and h0
# float32 ``[..., D]`` (zeros when None) and returns h, float32 ``[..., T,
# D]``; with no batch dims and no h0 it is the reference kernel's
# signature.  ``h_out=`` names a float32 ``[..., D]`` tensor the final
# state is written into, which may be ``h0``: the serving cache is updated
# in place.  a and b may be strided views, as long as the lane dim has
# unit stride and the batch dims fold into one; nothing is copied.
#
# Bound on the card: device memory (a, b read once, h written once; 2
# flops per 12 bytes in f32).  The kernel (``csrc/rglru_scan.cu``) runs one
# thread per (batch, lane), the state in a register, walking T with the
# next 8 steps' loads in flight; the TPU kernel's log-step scan within
# 256-row chunks and its VMEM carry have no counterpart.  Each step rounds
# the product and the sum separately, as the plain version does, so the
# two agree bit for bit; :func:`rglru_tolerance` states the f32 bound both
# meet around the float64 recurrence (the reference's jitted and Pallas
# forms sum in other orders or contract, and are held to it or to their
# own tests' bound).
#
# A CPU tensor goes to the plain version (:mod:`repro_torch.kernels.ref`);
# a CUDA tensor launches the kernel or raises.

# kernel launches made by rglru_scan (the main path's proof of use)
rglru_launches = 0


def _rglru_shapes(a, b, h0, h_out) -> tuple[tuple[int, ...], int, int]:
    """``(batch, T, D)``; raises on inconsistent shapes."""
    if a.dim() < 2 or a.shape != b.shape:
        raise ValueError(f"a and b must share a [..., T, D] shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    batch, t, d = tuple(a.shape[:-2]), a.shape[-2], a.shape[-1]
    for name, x in (("h0", h0), ("h_out", h_out)):
        if x is not None and tuple(x.shape) != batch + (d,):
            raise ValueError(f"{name} must be {batch + (d,)}, got "
                             f"{tuple(x.shape)}")
    return batch, t, d


def rglru_plain(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel."""
    _rglru_shapes(a, b, h0, None)
    return ref.rglru_scan(a, b, h0)


def _bt_strides(x: torch.Tensor, what: str) -> tuple[int, int]:
    """Element strides of (folded batch, time) of ``[*batch, T, D]``;
    raises unless the lane dim has unit stride and the batch dims fold
    into one without a copy."""
    if x.stride(-1) != 1 and x.shape[-1] > 1:
        raise ValueError(f"rglru_scan kernel needs a unit-stride lane dim "
                         f"in {what}, got strides {x.stride()}")
    dims = [(n, s) for n, s in zip(x.shape[:-2], x.stride()[:-2]) if n > 1]
    for (_, s_out), (n_in, s_in) in zip(dims, dims[1:]):
        if s_out != n_in * s_in:
            raise ValueError(f"rglru_scan kernel: the batch dims of {what} "
                             f"({tuple(x.shape)}, strides {x.stride()}) do "
                             "not fold into one")
    return (dims[-1][1] if dims else 0, x.stride(-2))


def _rglru_lib() -> ctypes.CDLL:
    lib = build.library("rglru_scan")
    fn = lib.acis_rglru_scan
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 \
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None, *,
               h_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t from ``h0``; returns h (notes above).
    With ``h_out`` the final state is written there (it may be ``h0``)."""
    global rglru_launches
    batch, t, d = _rglru_shapes(a, b, h0, h_out)
    if h_out is not None and (h_out.dtype != torch.float32
                              or not h_out.is_contiguous()):
        raise ValueError(f"h_out must be a contiguous float32 "
                         f"{batch + (d,)}, got {h_out.dtype}")
    ts = [x for x in (a, b, h0, h_out) if x is not None]
    if all(x.device.type == "cpu" for x in ts):
        h = rglru_plain(a, b, h0)
        if h_out is not None:
            h_out.copy_(h[..., -1, :] if t else
                        (h0 if h0 is not None else torch.zeros_like(h_out)))
        return h
    if a.device.type != "cuda" or any(x.device != a.device for x in ts):
        raise ValueError("rglru_scan runs on one CUDA device, got "
                         f"{[str(x.device) for x in ts]}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(f"rglru_scan kernel takes a and b of one dtype, "
                        f"float32 or bfloat16, got {a.dtype} and {b.dtype}")
    if h0 is not None and h0.dtype != torch.float32:
        raise TypeError(f"h0 must be float32, got {h0.dtype}")
    h = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    nb = math.prod(batch)
    if t == 0 or nb * d == 0:
        if h_out is not None and h0 is None:
            h_out.zero_()
        elif h_out is not None and h_out is not h0:
            h_out.copy_(h0)
        return h
    h0_b = 0
    if h0 is not None:
        if h0.stride(-1) != 1 and d > 1:
            raise ValueError("rglru_scan kernel needs a unit-stride h0")
        h0_b = _bt_strides(h0[..., None, :], "h0")[0]
    strides = (ctypes.c_int64 * 5)(*_bt_strides(a, "a"),
                                   *_bt_strides(b, "b"), h0_b)
    lib = _rglru_lib()
    with torch.cuda.device(a.device):
        rc = lib.acis_rglru_scan(
            a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), h.data_ptr(),
            None if h_out is None else h_out.data_ptr(), nb, t, d, strides,
            DTYPES[a.dtype],
            torch.cuda.current_stream(a.device).cuda_stream)
    rglru_launches += 1
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed (code {rc})")
    return h


def rglru_tolerance(a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(h_exact, tol)`` in float64: the recurrence on these inputs in
    float64, and the bound any f32 evaluation of it in time order meets,
    with the product and sum rounded separately or fused.

    Step t rounds ``a_t·h_{t-1}`` and the sum by at most u = 2^-24 of
    their magnitudes, and carries the error before it through ``|a_t|``:
    E_t = |a_t|·E_{t-1}·(1 + 2u) + u·(1 + u)·(|a_t·h_{t-1}| + |h_t|)
    (the factors cover the computed values' own departure from the exact
    ones).  It is worst case per step, so one unlucky rounding comes close
    to it; a dropped ``h0``, a dropped step or a reversed time order
    exceeds it by orders of magnitude (``tests/test_torch_rglru.py``).
    """
    f64 = torch.float64
    u = 2.0 ** -24
    a, b = a.to(f64), b.to(f64)
    h = torch.zeros(a.shape[:-2] + a.shape[-1:], dtype=f64,
                    device=a.device) if h0 is None else h0.to(f64)
    err = torch.zeros_like(h)
    hs, tols = [], []
    for t in range(a.shape[-2]):
        at = a[..., t, :]
        prod = at * h
        h = prod + b[..., t, :]
        err = at.abs() * err * (1 + 2 * u) \
            + u * (1 + u) * (prod.abs() + h.abs())
        hs.append(h)
        tols.append(err)
    if not hs:
        return torch.zeros_like(a), torch.zeros_like(a)
    return torch.stack(hs, -2), torch.stack(tols, -2)
