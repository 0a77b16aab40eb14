"""Plain PyTorch versions of every kernel's function.

The PyTorch counterpart of :mod:`repro.kernels.ref`: the semantics
contracts the hand-written kernels are held to.  The CPU path runs them,
and ``chip_smoke.py`` compares each CUDA kernel with them on the card.
Each repeats the reference oracle's arithmetic operation by operation
(with PyTorch's one rounding per elementwise op).

``pack_combine`` and ``topk_accumulate`` differ from the reference
oracles in one respect: they update their accumulator in place and
return it, because their kernels do (the reference returns a new array
and relies on buffer donation).  ``topk_accumulate`` also folds rank
dims into rows and drops out-of-range indices, as its kernel and the
reference's Pallas kernel do.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


# ---------------------------------------------------------------------------
# fused_combine — per-hop reduce combines (the switch aggregation unit)
# ---------------------------------------------------------------------------

def combine_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x + y


def combine_max(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, y)


def combine_min(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.minimum(x, y)


def combine_mac(acc: torch.Tensor, x: torch.Tensor,
                alpha: float = 1.0) -> torch.Tensor:
    """acc + alpha * x  (the paper's fused multiply-accumulate example);
    ``alpha`` is first cast to the operands' dtype, as in the reference."""
    return acc + torch.tensor(alpha, dtype=acc.dtype) * x


COMBINES = {"add": combine_add, "max": combine_max, "min": combine_min}


# ---------------------------------------------------------------------------
# pack_combine — bucket pack (+ optional combine) into a flat arena
# ---------------------------------------------------------------------------


def pack_combine(arena: torch.Tensor, *parts: torch.Tensor,
                 op: Optional[str] = None) -> torch.Tensor:
    """Write flat ``parts`` back to back into ``arena`` in place; with
    ``op`` set, combine each part into the arena's current segment
    instead.  Every dim of ``arena`` but the last is a row (a rank) and
    each part is ``[*rows, size]`` (or any shape with that many
    elements per row)."""
    rows = tuple(arena.shape[:-1])
    off = 0
    for p in parts:
        p = p.reshape(rows + (-1,)).to(arena.dtype)
        s = p.shape[-1]
        seg = arena[..., off:off + s]
        if op is not None:
            p = COMBINES[op](seg, p)
        seg.copy_(p)
        off += s
    return arena


# ---------------------------------------------------------------------------
# quant_combine — encoded-domain int8 combine (dequant-add-requant)
# ---------------------------------------------------------------------------

def block_scale(absmax: torch.Tensor) -> torch.Tensor:
    """``absmax / 127`` per block, 1.0 where the block is all zero.

    The divisor is a tensor on purpose: PyTorch's CUDA kernels divide by
    a Python scalar as a multiply by its reciprocal, one rounding away
    from the IEEE division the CPU does (and the ``quant_combine``
    kernel does), which moves a lane near a rounding tie by one int8
    step.  Tensor by tensor, every device divides."""
    return torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                       torch.ones_like(absmax))


def quant_combine(qa: torch.Tensor, sa: torch.Tensor,
                  qb: torch.Tensor, sb: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Combine two blockwise-int8 payloads: q[B, block], s[B]."""
    acc = qa.to(torch.float32) * sa[..., None] \
        + qb.to(torch.float32) * sb[..., None]
    scale = block_scale(acc.abs().amax(dim=-1))
    q = torch.clamp(torch.round(acc / scale[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale


# ---------------------------------------------------------------------------
# topk_accumulate — sparse (idx, val) scatter-add into a dense accumulator
# ---------------------------------------------------------------------------

def topk_accumulate(dense: torch.Tensor, idx: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """dense[idx] += vals in place (duplicate indices accumulate).

    ``dense`` is ``[*rows, size]`` and ``idx``/``vals`` are
    ``[*rows, k]``: row ``r`` adds into ``dense[r]``.  Indices outside
    ``[0, size)`` are dropped."""
    size = dense.shape[-1]
    rows = math.prod(dense.shape[:-1])
    i = idx.reshape(rows, -1).to(torch.int64)
    keep = (i >= 0) & (i < size)
    offs = i + torch.arange(rows, device=i.device)[:, None] * size
    dense.view(-1).index_add_(
        0, offs[keep], vals.reshape(rows, -1).to(dense.dtype)[keep])
    return dense


# ---------------------------------------------------------------------------
# prefix_sum — long-vector inclusive scan
# ---------------------------------------------------------------------------

def prefix_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inclusive prefix sum along ``dim`` in ``x``'s dtype (as
    ``jnp.cumsum`` keeps it; ``torch.cumsum`` alone widens integers)."""
    return torch.cumsum(x, dim=dim, dtype=x.dtype)


# ---------------------------------------------------------------------------
# rglru_scan — gated linear recurrence  h_t = a_t * h_{t-1} + b_t
# ---------------------------------------------------------------------------

def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over the time dim of ``[..., T, D]``
    inputs (leading dims batch, D lanes), from ``h0`` ``[..., D]`` (zeros
    when None).  Computed in float32, each product and sum rounded once,
    and returned as float32 ``[..., T, D]``, as the TPU kernel does."""
    f32 = torch.float32
    a, b = a.to(f32), b.to(f32)
    h = torch.zeros(a.shape[:-2] + a.shape[-1:], dtype=f32,
                    device=a.device) if h0 is None else h0.to(f32)
    hs = []
    for t in range(a.shape[-2]):
        h = a[..., t, :] * h + b[..., t, :]
        hs.append(h)
    return torch.stack(hs, -2) if hs else torch.zeros_like(a)


# ---------------------------------------------------------------------------
# rwkv6 — data-dependent-decay WKV recurrence (multi-head, batched)
# ---------------------------------------------------------------------------

def rwkv6_recurrence(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     s0: Optional[torch.Tensor] = None, *,
                     kv_bf16: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 "Finch" WKV, batched over leading dims.

    r, k, w: [..., T, K], v: [..., T, V], u: [..., K] (broadcast against
    the leading dims: ``[H, K]`` for ``[*batch, H, T, K]`` inputs), s0:
    [..., K, V] (zeros when None).  Per token, in float32:
      kv  = k_t ⊗ v_t                  (rounded to bf16 if ``kv_bf16``)
      o_t = Σ_k r_t[k] · (S + u ⊙ kv)[k, :]
      S   = diag(w_t) S + kv
    Returns (o: [..., T, V] in v's dtype, S_T: [..., K, V] float32).
    ``kv_bf16`` repeats the reference's serving arithmetic
    (``rwkv6_decode`` forms kv from bf16 k and v, so in bf16); the
    default is the TPU kernel's exact f32 product.
    """
    f32 = torch.float32
    T, V, out_dtype = v.shape[-2], v.shape[-1], v.dtype
    lead = torch.broadcast_shapes(r.shape[:-2], v.shape[:-2],
                                  u.shape[:-1])
    S = torch.zeros(lead + (r.shape[-1], V), dtype=f32, device=r.device) \
        if s0 is None else s0.to(f32)
    r, k, v, w, u = (t.to(f32) for t in (r, k, v, w, u))
    os = []
    for t in range(T):
        kv = k[..., t, :, None] * v[..., t, None, :]           # [..., K, V]
        if kv_bf16:
            kv = kv.to(torch.bfloat16).to(f32)
        os.append(((S + u[..., :, None] * kv) * r[..., t, :, None]).sum(-2))
        S = w[..., t, :, None] * S + kv
    o = torch.stack(os, -2) if os else torch.zeros(
        lead + (0, V), dtype=f32, device=r.device)
    return o.to(out_dtype), S
