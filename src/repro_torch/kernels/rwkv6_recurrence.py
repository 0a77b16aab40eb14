"""RWKV-6 "Finch" WKV recurrence (data-dependent decay) — CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/rwkv6_recurrence.py:
rwkv6_recurrence`` (body ``_wkv_kernel``).  The reference names it the TPU
fast path for serving but never calls it: its decode computes the step in
plain jnp and its prefill runs T decode steps.  In the port the kernel
computes the WKV of every decode step and of the whole prompt in prefill
(:func:`repro_torch.models.rwkv6.wkv`), one launch per layer.

``rwkv6_recurrence(r, k, v, w, u, s0=None, *, kv_bf16=False)`` takes r,
k, w ``[*batch, H, T, K]``, v ``[*batch, H, T, V]``, u ``[H, K]`` and s0
(f32 ``[*batch, H, K, V]``, zeros when None) and returns ``(o, s)``: o
``[*batch, H, T, V]`` in v's dtype and the final state s, f32
``[*batch, H, K, V]``.  With no batch dims and no s0 it is the reference
kernel's signature.  Inputs may be strided views (the model passes its
``[B, T, H, K]`` activations transposed) as long as the last dim has unit
stride and the batch dims fold into one; o comes back with v's strides.
``s_out=`` names the tensor the final state is written into, which may be
``s0`` itself: the serving cache is updated in place.

Bound on the card: at the prefill shape (``[8, 512, 32, 64]`` bf16 in the
model's layout) operations — about 8 f32 flops per (k, v) per token —
over the H100's f32 rate, above the bytes over its memory rate; decode
(T = 1) moves the f32 state in and out, so bytes bound it there.  The
kernel (``csrc/rwkv6_recurrence.cu``) splits each (batch, head)'s state
over its threads by value column and by key row (:func:`launch_shape`:
at K = V = 64, one block of 256 threads per (batch, head); 8 lanes share
2 columns, 8 rows each in registers), and steps over T with r, k, w and v
of 16 tokens copied into a ring of 3 shared-memory stages by
``cp.async``; each lane's partial sums of o go to shared memory and are
summed over the 8 lanes once per chunk.  K and V up to 64.

Numbers: r, k, v in float32 or bfloat16 (one dtype), w float32 (a bf16 or
f16 w is widened, never narrowed: the decay near 1 needs f32), u, s0 and
the arithmetic f32.  ``kv_bf16`` rounds ``k ⊗ v`` to bf16 before use, as
the reference's ``rwkv6_decode`` does by forming it from bf16 operands;
the default is the TPU kernel's exact f32 product.  The kernel sums over k
in its own order (two partial sums per lane over its rows, then a
pairwise tree over the lanes of a column) with fused multiply-adds, so it
agrees with the plain version to f32 rounding: :func:`wkv_tolerance`
states the bound, which holds for any order.

A CPU tensor goes to the plain version (:mod:`repro_torch.kernels.ref`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

MAX_K = MAX_V = 64               # csrc/rwkv6_recurrence.cu: kMaxK, kMaxV
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/rwkv6_recurrence.cu's default launch shape (the ACIS_WKV_* macros)
GROUPS, VCOLS, COLS_PER_THREAD, CHUNK, STAGES, UNROLL = 8, 64, 2, 16, 3, 4
SHAPE_KEYS = ("kp", "groups", "rows", "vcols", "cpt", "threads", "blocks",
              "chunk", "stages", "unroll")

# kernel launches made by rwkv6_recurrence (the main path's proof of use)
launches = 0


def _shapes(r, k, v, w, u, s0):
    """``(batch, H, T, K, V)``; raises on inconsistent shapes."""
    if r.dim() < 3:
        raise ValueError(f"r must be [*batch, H, T, K], got {tuple(r.shape)}")
    batch = tuple(r.shape[:-3])
    h, t, kk = r.shape[-3:]
    vv = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"r, k and w must share a shape, got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(w.shape)}")
    if tuple(v.shape) != batch + (h, t, vv):
        raise ValueError(f"v must be {batch + (h, t, 'V')}, got "
                         f"{tuple(v.shape)}")
    if tuple(u.shape) != (h, kk):
        raise ValueError(f"u must be [H, K] = {(h, kk)}, got "
                         f"{tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != batch + (h, kk, vv):
        raise ValueError(f"s0 must be {batch + (h, kk, vv)}, got "
                         f"{tuple(s0.shape)}")
    return batch, h, t, kk, vv


def plain(r, k, v, w, u, s0=None, *, kv_bf16: bool = False):
    """The plain PyTorch version of the kernel."""
    _shapes(r, k, v, w, u, s0)
    return ref.rwkv6_recurrence(r, k, v, w, u, s0, kv_bf16=kv_bf16)


def _bht_strides(x: torch.Tensor) -> tuple[int, int, int]:
    """Element strides of (folded batch, head, time) of ``[*batch, H, T,
    X]``; raises unless the last dim has unit stride and the batch dims
    fold into one without a copy."""
    if x.stride(-1) != 1 and x.shape[-1] > 1:
        raise ValueError("rwkv6_recurrence kernel needs a unit-stride last "
                         f"dim, got strides {x.stride()}")
    dims = [(n, s) for n, s in zip(x.shape[:-3], x.stride()[:-3]) if n > 1]
    for (_, s_out), (n_in, s_in) in zip(dims, dims[1:]):
        if s_out != n_in * s_in:
            raise ValueError("rwkv6_recurrence kernel: the batch dims of a "
                             f"{tuple(x.shape)} tensor with strides "
                             f"{x.stride()} do not fold into one")
    return (dims[-1][1] if dims else 0, x.stride(-3), x.stride(-2))


def launch_shape(k: int, v: int, *, groups: int = GROUPS,
                 vcols: int = VCOLS, cpt: int = COLS_PER_THREAD) -> dict:
    """The kernel's launch shape for K = ``k`` and V = ``v``, as
    ``acis_rwkv6_launch_shape`` reports it: K padded to 16, 32 or 64;
    ``groups`` lanes share a value column (fewer where the padded K has
    fewer than 4 rows a lane), each with ``rows`` rows of it; ``cpt``
    consecutive columns a thread, ``vcols`` a block; ``blocks`` per
    (batch, head) along V."""
    kp = 16 if k <= 16 else 32 if k <= 32 else 64
    g = min(groups, kp // 4)
    return {"kp": kp, "groups": g, "rows": kp // g, "vcols": vcols,
            "cpt": cpt, "threads": vcols // cpt * g,
            "blocks": -(-v // vcols), "chunk": CHUNK, "stages": STAGES,
            "unroll": UNROLL}


def lanes(k: int, v: int, **shape) -> list[list[list[tuple[int, int]]]]:
    """``[block][thread]`` -> the (row, column) lanes of one (batch,
    head)'s state that thread holds, as the kernel assigns them: lane g of
    a group of ``groups`` consecutive lanes holds rows ``4 (g + groups m)
    + q`` (q < 4) of columns ``cpt · cs + c`` (c < cpt) of its block's
    ``vcols``, where ``cs = 32 / groups · warp + lane / groups``.  Rows at
    or past K and columns at or past V are padding, left out."""
    sh = launch_shape(k, v, **shape)
    g_, cpt = sh["groups"], sh["cpt"]
    out = []
    for blk in range(sh["blocks"]):
        threads = []
        for tid in range(sh["threads"]):
            lane, g = tid % 32, tid % 32 % g_
            cs = tid // 32 * (32 // g_) + lane // g_
            cols = [blk * sh["vcols"] + cs * cpt + c for c in range(cpt)]
            rows = [4 * (g + g_ * m) + q for m in range(sh["rows"] // 4)
                    for q in range(4)]
            threads.append([(i, c) for c in cols for i in rows
                            if i < k and c < v])
        out.append(threads)
    return out


_LIB: Optional[ctypes.CDLL] = None


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/rwkv6_recurrence.cu``) with its entry
    points typed."""
    lib.acis_rwkv6_recurrence.argtypes = [ctypes.c_void_p] * 8 \
        + [ctypes.c_int64] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.acis_rwkv6_recurrence.restype = ctypes.c_int
    lib.acis_rwkv6_launch_shape.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p]
    lib.acis_rwkv6_launch_shape.restype = None
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = typed(build.library("rwkv6_recurrence"))
    return _LIB


def built_launch_shape(k: int, v: int, lib=None) -> dict:
    """:func:`launch_shape` as the built library reports it (card only)."""
    out = (ctypes.c_int * len(SHAPE_KEYS))()
    (lib or _lib()).acis_rwkv6_launch_shape(k, v, out)
    return dict(zip(SHAPE_KEYS, out))


def rwkv6_recurrence(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     s0: Optional[torch.Tensor] = None, *,
                     kv_bf16: bool = False,
                     s_out: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-head WKV6 from ``s0``; returns ``(o, s)`` (module docstring).
    With ``s_out`` the final state is written there (it may be ``s0``)
    and ``s`` is ``s_out``."""
    global launches
    batch, h, t, kk, vv = _shapes(r, k, v, w, u, s0)
    s_shape = batch + (h, kk, vv)
    if s_out is not None and (tuple(s_out.shape) != s_shape
                              or s_out.dtype != torch.float32
                              or not s_out.is_contiguous()):
        raise ValueError(f"s_out must be a contiguous float32 {s_shape}, "
                         f"got {s_out.dtype} {tuple(s_out.shape)}")
    ts = [x for x in (r, k, v, w, u, s0, s_out) if x is not None]
    if all(x.device.type == "cpu" for x in ts):
        o, s = plain(r, k, v, w, u, s0, kv_bf16=kv_bf16)
        if s_out is not None:
            s = s_out.copy_(s)
        return o, s
    if r.device.type != "cuda" or any(x.device != r.device for x in ts):
        raise ValueError("rwkv6_recurrence runs on one CUDA device, got "
                         f"{[str(x.device) for x in ts]}")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_recurrence kernel takes r, k, v of one "
                        f"dtype, float32 or bfloat16, got {r.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (w.dtype.is_floating_point and w.element_size() <= 4):
        raise TypeError(f"w must be a float32 (or narrower) decay, got "
                        f"{w.dtype}")
    if not (1 <= kk <= MAX_K and 1 <= vv <= MAX_V):
        raise ValueError(f"rwkv6_recurrence kernel takes K and V in "
                         f"[1, {MAX_K}], got K={kk}, V={vv}")
    w = w.to(torch.float32)                   # widening only: exact
    u = u.to(torch.float32).contiguous()
    if s0 is not None and (s0.dtype != torch.float32
                           or not s0.is_contiguous()):
        raise ValueError("s0 must be a contiguous float32 state")
    o = torch.empty_like(v)                   # v's strides: a layout view
    s = s_out if s_out is not None else torch.empty(
        s_shape, dtype=torch.float32, device=r.device)
    b = math.prod(batch)
    if t == 0 or b * h == 0:
        if s0 is None:
            s.zero_()
        elif s is not s0:
            s.copy_(s0)
        return o, s
    strides = (ctypes.c_int64 * 15)(*(
        st for x in (r, k, v, w, o) for st in _bht_strides(x)))
    dev = r.get_device()
    rc = _lib().acis_rwkv6_recurrence(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if s0 is None else s0.data_ptr(), s.data_ptr(), o.data_ptr(),
        b, h, t, kk, vv, strides, DTYPES[r.dtype], int(bool(kv_bf16)), dev,
        build.stream_of(dev))
    launches += 1
    if rc != 0:
        raise RuntimeError(f"rwkv6_recurrence kernel launch failed "
                           f"(code {rc})")
    return o, s


def wkv_tolerance(r, k, v, w, u, s0=None, *, kv_bf16: bool = False
                  ) -> tuple[torch.Tensor, ...]:
    """``(o_exact, s_exact, o_tol, s_tol)`` in float64: the recurrence on
    these inputs in float64 (kv rounded to bf16 first where ``kv_bf16``
    says so, as both versions do), and the bound any f32 evaluation of it
    meets, in any summation order, with or without fused multiply-adds.

    Each state step rounds ``w·S``, the add and the f32 ``k·v`` by at
    most 2^-24 of a value bounded by A_t, the recurrence on absolute
    values (A_t = |w_t|·A_{t-1} + |kv_t|), so the state error obeys
    E_t = |w_t|·E_{t-1} + 3·2^-24·A_t.  An output sums K terms
    ``r·(S + u·kv)``: E_{t-1} carried through |r|, plus (K + 3)·2^-24 of
    Σ|r|·(A_{t-1} + |u·kv|), plus its own rounding to v's dtype (2^-8
    of |o| for bf16, 2^-24 for f32).  Worst case and linear in t, yet
    tight enough that a dropped token or a dropped ``u`` term shows
    (``tests/test_torch_rwkv6.py``)."""
    f64 = torch.float64
    u_ = 2.0 ** -24
    T, K, V = r.shape[-2], r.shape[-1], v.shape[-1]
    out_u = 2.0 ** -8 if v.dtype == torch.bfloat16 else u_
    r, k, v, w, uu = (x.to(f64) for x in (r, k, v, w, u))
    S = torch.zeros(torch.broadcast_shapes(r.shape[:-2], uu.shape[:-1])
                    + (K, V), dtype=f64, device=r.device) \
        if s0 is None else s0.to(f64)
    A, E = S.abs(), torch.zeros_like(S)
    os, otols = [], []
    for t in range(T):
        kv = k[..., t, :, None] * v[..., t, None, :]   # exact: f32 operands
        if kv_bf16:
            kv = kv.to(torch.float32).to(torch.bfloat16).to(f64)
        rt = r[..., t, :, None].abs()
        ukv = uu[..., :, None] * kv
        os.append(((S + ukv) * r[..., t, :, None]).sum(-2))
        otols.append((rt * E).sum(-2)
                     + (K + 3) * u_ * (rt * (A + ukv.abs())).sum(-2))
        wt = w[..., t, :, None]
        S = wt * S + kv
        A = wt.abs() * A + kv.abs()
        E = wt.abs() * E + 3 * u_ * A
    o = torch.stack(os, -2) if os else torch.zeros(
        S.shape[:-2] + (0, V), dtype=f64, device=r.device)
    otol = torch.stack(otols, -2) if otols else torch.zeros_like(o)
    return o, S, otol + out_u * o.abs(), E
