"""Fused attention on the tensor cores, forward and backward — CUDA kernels.

Replaces no TPU kernel: the reference's attention
(``repro/models/attention.py:flash_attention``) is a KV-chunked
``lax.scan`` that XLA fuses, and has no Pallas kernel.  It was added
because the port's plain PyTorch form of that scan (f32 scores, one pass
over them per softmax step, a ragged last chunk padded with a copy, f32
einsums off the tensor cores) held about half of a whisper-small train
step.  :func:`repro_torch.models.attention.flash_attention` sends the
calls :func:`takes` names here; the rest keep the plain loop.

``flash_attention(q, k, v, causal=, window=, q_offset=, scale=)`` takes
bf16 q ``[..., B, Tq, Hq, d]``, k ``[..., B, Tk, Hkv, d]`` and v ``[...,
B, Tk, Hkv, dv]`` (one set of leading dims, ``Hq % Hkv == 0``; query head
h reads KV head ``h // (Hq // Hkv)``; the widths :func:`widths` names:
``d == dv <= 128`` a multiple of 8, or multi-head latent attention's
per-head ``d = 192``, ``dv = 128``) and returns the attention ``[..., B,
Tq, Hq, dv]`` in bf16 through a :class:`torch.autograd.Function` whose
backward is a kernel too.  Key ``j`` is visible to query row ``i`` when
``lo < j - i <= hi`` (:func:`mask_bounds`: causal ``hi = q_offset``, a
window ``lo = q_offset - window``).

Accuracy is the plain form's f32 result, not a bf16 one: products of bf16
values (q k^T, dO V^T) go to the tensor cores as they are, with f32 sums,
and every f32 operand (P in P V and in dV, dS in dQ and dK) as the three
bf16 parts of :func:`split3`, which sum back to it exactly.  The softmax
keeps f32 statistics in registers; the backward reads the f32 O for D =
rowsum(dO * O), as autograd of the plain form differentiates the f32
output before its cast.  :func:`plain_forward` and :func:`plain_backward`
are the kernels' equations in plain PyTorch.

Bound on the card: tensor-core operations (:func:`work`), far above the
bytes at whisper's 1,500 frames.  The design (``csrc/flash_attention.cu``,
FlashAttention-2's form): a block of 4 warps per 64-row tile, mma.sync
m16n8k16 from swizzled shared memory, the next tile copied in by
cp.async while one computes, wholly masked tiles skipped, the ragged last
tile masked in registers.  The backward is deterministic (no atomics): a
dK/dV kernel loops over the query tiles and heads that read a K/V tile, a
dQ kernel over the K/V tiles a query tile sees.

A CUDA tensor launches the kernels or raises; the plain versions serve
the CPU tests and ``chip_smoke.py``'s comparison on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.obs import metrics as _metrics

INT_MAX = 2 ** 31 - 1
LOG2E = 1.4426950408889634

# kernel launches: forward, and backward (each one D, one dK/dV and one
# dQ launch) — the main path's proof of use
launches = 0
bwd_launches = 0

# the key width different from the value width that the kernels take
WIDE = (192, 128)


def mask_bounds(causal: bool, window: Optional[int],
                q_offset: int) -> tuple[Optional[int], Optional[int]]:
    """``(hi, lo)``: key j is visible to query row i when ``lo < j - i <=
    hi``; None for no bound."""
    return (q_offset if causal else None,
            q_offset - window if window is not None else None)


def rows_see_keys(tq: int, tk: int, causal: bool, window: Optional[int],
                  q_offset: int) -> bool:
    """True when each of ``tq`` query rows sees at least one of ``tk``
    keys (row i sees ``max(0, i + lo + 1) .. min(tk - 1, i + hi)``)."""
    hi, lo = mask_bounds(causal, window, q_offset)
    hi = math.inf if hi is None else hi
    lo = -math.inf if lo is None else lo
    return tq >= 1 and tk >= 1 and hi >= 0 and lo + tq + 1 <= tk \
        and lo + 1 <= hi


def widths(d: int, dv: int) -> bool:
    """The key and value widths the kernels are built for: ``d == dv <=
    128`` a multiple of 8, or :data:`WIDE`."""
    return (d == dv <= 128 and d % 8 == 0) or (d, dv) == WIDE


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool, window: Optional[int], q_offset, kv_len) -> bool:
    """The one rule that sends an attention call to these kernels: CUDA
    operands, an int ``q_offset`` and no ``kv_len`` (full sequences),
    bf16 q, k, v with one set of leading dims, key and value widths that
    :func:`widths` names, ``Hq % Hkv == 0``, and every query row seeing a
    key (the plain loop gives a row that sees none the mean of a chunk's
    values)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or kv_len is not None \
            or not isinstance(q_offset, int) or q.dim() < 3:
        return False
    tq, hq, d = q.shape[-3:]
    tk, hkv, dv = v.shape[-3:]
    return (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.shape[:-3] == k.shape[:-3] == v.shape[:-3]
            and k.shape[-3:] == (tk, hkv, d) and widths(d, dv)
            and hq % hkv == 0
            and rows_see_keys(tq, tk, causal, window, q_offset))


def split3(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """f32 ``x`` as bf16 ``hi + mid + lo``, each part the round to nearest
    of what the parts before it leave: the kernels' operand split, which
    sums back to ``x`` exactly (24 significand bits in three runs of 8)
    wherever the parts stay above bf16's smallest normal."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def _visible(tq: int, tk: int, hi, lo, device) -> torch.Tensor:
    rel = torch.arange(tk, device=device)[None] \
        - torch.arange(tq, device=device)[:, None]
    ok = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if hi is not None:
        ok &= rel <= hi
    if lo is not None:
        ok &= rel > lo
    return ok


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or in f64 where it is f64 (an exact reference)."""
    return x if x.dtype == torch.float64 else x.float()


def _heads(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[..., T, Hq, d] -> [..., T, Hkv, G, d], widened."""
    return _wide(x).reshape(x.shape[:-2] + (hkv, -1, x.shape[-1]))


def plain_probs(q, k, *, hi=None, lo=None, scale: float, lse=None):
    """P ``[..., Hkv, G, Tq, Tk]`` from the scores' own max and sum, with
    their log2-sum-exp ``[..., Hkv, G, Tq]``; or, given ``lse``, P
    recomputed from it (and None).  Masked keys give 0."""
    tq, tk, hkv = q.shape[-3], k.shape[-3], k.shape[-2]
    s = torch.einsum("...qhgd,...khd->...hgqk", _heads(q, hkv), _wide(k)) \
        * (scale * LOG2E)
    s = s.masked_fill(~_visible(tq, tk, hi, lo, q.device), -math.inf)
    if lse is None:
        m = s.amax(-1, keepdim=True)
        p = torch.exp2(s - m)
        l_ = p.sum(-1, keepdim=True)
        return p / l_, (m + torch.log2(l_))[..., 0]
    lse = lse.reshape(lse.shape[:-2] + (hkv, -1, tq))
    return torch.exp2(s - lse[..., None]), None


def plain_forward(q, k, v, *, hi=None, lo=None, scale: float):
    """The forward kernel's equations: ``(o32, lse)``, the f32 output
    ``[..., Tq, Hq, d]`` and the log2-sum-exp of the scaled scores
    ``[..., Hq, Tq]``.  Every row must see a key."""
    p, lse = plain_probs(q, k, hi=hi, lo=lo, scale=scale)
    o = torch.einsum("...hgqk,...khd->...qhgd", p, _wide(v))
    return (o.reshape(q.shape[:-2] + (-1, v.shape[-1])),
            lse.reshape(lse.shape[:-3] + (-1, q.shape[-3])))


def plain_backward(q, k, v, o32, lse, do, *, hi=None, lo=None,
                   scale: float):
    """The backward kernels' equations, f32: P recomputed from the LSE,
    D = rowsum(dO * O) from the f32 O, dS = P (dP - D); returns
    ``(dq, dk, dv)``."""
    hkv = k.shape[-2]
    p, _ = plain_probs(q, k, hi=hi, lo=lo, scale=scale, lse=lse)
    dof = _heads(do, hkv)
    dsum = (dof * _heads(o32, hkv)).sum(-1).movedim(-3, -1)
    dp = torch.einsum("...qhgd,...khd->...hgqk", dof, _wide(v))
    ds = p * (dp - dsum[..., None])
    dv = torch.einsum("...hgqk,...qhgd->...khd", p, dof)
    dk = torch.einsum("...hgqk,...qhgd->...khd", ds, _heads(q, hkv)) * scale
    dq = torch.einsum("...hgqk,...khd->...qhgd", ds, _wide(k)) * scale
    return dq.reshape(q.shape), dk, dv


def visible_pairs(tq: int, tk: int, hi=None, lo=None) -> int:
    """The (row, key) pairs the mask of :func:`mask_bounds` leaves
    visible: row i sees keys ``max(0, i + lo + 1) .. min(tk - 1, i +
    hi)``."""
    i = torch.arange(tq, dtype=torch.int64)
    first = (i + lo + 1).clamp_min(0) if lo is not None \
        else torch.zeros_like(i)
    last = (i + hi).clamp_max(tk - 1) if hi is not None \
        else torch.full_like(i, tk - 1)
    return int((last - first + 1).clamp_min(0).sum())


def work(nb: int, tq: int, tk: int, hq: int, d: int, hi=None,
         lo=None, dv: Optional[int] = None) -> dict:
    """Tensor-core operations of the kernels over the visible (row, key)
    pairs, q and k ``d`` wide and v ``dv`` (``d`` by default):
    ``forward`` 2d (S) + 3 * 2dv (P V in three parts), ``backward``
    2 * 2d (S, recomputed in both kernels) + 2 * 2dv (dP, in both) +
    3 * 2dv (dV) + 3 * 2 * 2d (dK, dQ); ``plain`` the attention's own
    2(d + dv) forward and 2(3d + 2dv) backward.  Wholly masked tiles are
    skipped, so the pairs are the visible ones."""
    dv = d if dv is None else dv
    pairs = nb * hq * visible_pairs(tq, tk, hi, lo)
    return {"forward": pairs * (2 * d + 6 * dv),
            "backward": pairs * (16 * d + 10 * dv),
            "plain_forward": pairs * 2 * (d + dv),
            "plain_backward": pairs * 2 * (3 * d + 2 * dv)}


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The library, its entry points typed once at load."""
    global _LIB
    if _LIB is None:
        lib = build.library("flash_attention")
        shape = [ctypes.c_int64] + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.acis_flash_fwd.argtypes = [ctypes.c_void_p] * 6 + shape
        lib.acis_flash_fwd.restype = ctypes.c_int
        lib.acis_flash_bwd.argtypes = [ctypes.c_void_p] * 10 + shape
        lib.acis_flash_bwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _bounds(hi: Optional[int], lo: Optional[int]) -> tuple[int, int]:
    """The mask bounds as the kernels' ints: no bound as the int range's
    end, the others clamped into it (where every relative position
    lies)."""
    return (INT_MAX if hi is None else max(-INT_MAX, min(INT_MAX, hi)),
            -INT_MAX - 1 if lo is None else max(-INT_MAX, min(INT_MAX, lo)))


def _check(q, k, v, *more) -> None:
    """Raises for operands the kernels do not take."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention runs on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"flash_attention kernel takes bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3] or k.shape[0] != q.shape[0] \
            or k.shape[-1] != q.shape[-1] or q.shape[2] % k.shape[2] \
            or not widths(q.shape[-1], v.shape[-1]):
        raise ValueError(f"flash_attention kernel takes q [nb, tq, hq, d], "
                         f"k [nb, tk, hkv, d] and v [nb, tk, hkv, dv] with "
                         f"widths d, dv as widths() names and hkv dividing "
                         f"hq, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0
               for x in (q, k, v, *more)):
        raise ValueError("flash_attention kernels take contiguous operands "
                         "on 16-byte boundaries")


def _operand(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels' copies read it."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def forward(q, k, v, *, hi: Optional[int], lo: Optional[int],
            scale: float):
    """The forward kernel on ``[nb, t, h, d]`` operands (v ``dv``
    wide), the mask of :func:`mask_bounds`: ``(o, o32, lse)``, o ``[nb,
    tq, hq, dv]`` in bf16."""
    global launches
    _check(q, k, v)
    nb, tq, hq, d = q.shape
    dv = v.shape[-1]
    o = torch.empty((nb, tq, hq, dv), dtype=q.dtype, device=q.device)
    o32 = torch.empty(o.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((nb, hq, tq), dtype=torch.float32, device=q.device)
    dev = q.get_device()
    rc = _lib().acis_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        o32.data_ptr(), lse.data_ptr(), nb, tq, k.shape[1], hq, k.shape[2],
        d, dv, *_bounds(hi, lo), scale, dev, build.stream_of(dev))
    launches += 1
    if rc != 0:
        raise RuntimeError(f"flash_attention forward launch failed "
                           f"(code {rc})")
    return o, o32, lse


def backward(q, k, v, o32, lse, do, *, hi: Optional[int],
             lo: Optional[int], scale: float):
    """The backward kernels: ``(dq, dk, dv)`` in bf16."""
    global bwd_launches
    _check(q, k, v, o32, lse, do)
    if do.shape != o32.shape or do.dtype != torch.bfloat16:
        raise ValueError(f"dO must be bf16 {tuple(o32.shape)}, got "
                         f"{do.dtype} {tuple(do.shape)}")
    nb, tq, hq, d = q.shape
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dsum = torch.empty((nb, hq, tq), dtype=torch.float32, device=q.device)
    dev = q.get_device()
    rc = _lib().acis_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), nb, tq, k.shape[1], hq, k.shape[2], d,
        v.shape[-1], *_bounds(hi, lo), scale, dev, build.stream_of(dev))
    bwd_launches += 1
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed "
                           f"(code {rc})")
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, hi: Optional[int], lo: Optional[int],
                scale: float):
        o, o32, lse = forward(q, k, v, hi=hi, lo=lo, scale=scale)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.mask = (hi, lo, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o32, lse = ctx.saved_tensors
        hi, lo, scale = ctx.mask
        dq, dk, dv = backward(q, k, v, o32, lse, _operand(do), hi=hi, lo=lo,
                              scale=scale)
        rec = _metrics.RECORDER
        if rec.spans is not None:
            rec.count("kernel.attention.flops",
                      operations(q, k, v, hi, lo)["plain_backward"])
        return dq, dk, dv, None, None, None


def operations(q, k, v, hi, lo) -> dict:
    """:func:`work` of ``[nb, t, h, ·]`` operands under the mask bounds."""
    nb, tq, hq, d = q.shape
    return work(nb, tq, k.shape[1], hq, d, hi, lo, dv=v.shape[-1])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: Optional[int], q_offset: int,
                    scale: float) -> torch.Tensor:
    """Attention of bf16 ``q [..., Tq, Hq, d]`` over ``k [..., Tk, Hkv,
    d]`` and ``v [..., Tk, Hkv, dv]`` (the same leading dims) on the card,
    differentiable; returns ``[..., Tq, Hq, dv]`` in bf16.  While spans
    are recorded, ``kernel.attention.flops`` counts the attention's own
    operations (:func:`work`'s ``plain_forward``, and ``plain_backward``
    when the backward runs)."""
    hi, lo = mask_bounds(causal, window, q_offset)
    flat = [_operand(x.reshape((-1,) + x.shape[-3:])) for x in (q, k, v)]
    rec = _metrics.RECORDER
    if rec.spans is not None:
        rec.count("kernel.attention.flops",
                  operations(*flat, hi, lo)["plain_forward"])
    o = _Attention.apply(*flat, hi, lo, float(scale))
    return o.reshape(q.shape[:-1] + (v.shape[-1],))
