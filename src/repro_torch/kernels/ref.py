"""Plain PyTorch versions of every kernel's function.

The PyTorch counterpart of :mod:`repro.kernels.ref`: the semantics
contracts the hand-written kernels are held to.  The CPU path runs them,
and ``chip_smoke.py`` compares each CUDA kernel with them on the card.
Each repeats the reference oracle's arithmetic operation by operation
(with PyTorch's one rounding per elementwise op).

``pack_combine`` differs from the reference oracle in one respect: it
writes the arena in place and returns it, because its kernel does (the
reference returns a new array and relies on buffer donation).
"""

from __future__ import annotations

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


# ---------------------------------------------------------------------------
# pack_combine — bucket pack (+ optional combine) into a flat arena
# ---------------------------------------------------------------------------

_PACK_COMBINE = {
    "add": lambda a, b: a + b,
    "max": torch.maximum,
    "min": torch.minimum,
}


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
            p = _PACK_COMBINE[op](seg, p)
        seg.copy_(p)
        off += s
    return arena


# ---------------------------------------------------------------------------
# quant_combine — encoded-domain int8 combine (dequant-add-requant)
# ---------------------------------------------------------------------------

def quant_combine(qa: torch.Tensor, sa: torch.Tensor,
                  qb: torch.Tensor, sb: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Combine two blockwise-int8 payloads: q[B, block], s[B]."""
    acc = qa.to(torch.float32) * sa[..., None] \
        + qb.to(torch.float32) * sb[..., None]
    absmax = acc.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(acc / scale[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale


# ---------------------------------------------------------------------------
# topk_accumulate — sparse (idx, val) scatter-add into a dense accumulator
# ---------------------------------------------------------------------------

def topk_accumulate(dense: torch.Tensor, idx: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """dense[idx] += vals   (duplicate indices accumulate)."""
    return dense.index_add(0, idx.to(torch.int64), vals.to(dense.dtype))


# ---------------------------------------------------------------------------
# prefix_sum — long-vector inclusive scan
# ---------------------------------------------------------------------------

def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=0)


# ---------------------------------------------------------------------------
# rglru_scan — gated linear recurrence  h_t = a_t * h_{t-1} + b_t
# ---------------------------------------------------------------------------

def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a, b: [T, D]; returns h: [T, D] with h_t = a_t*h_{t-1} + b_t."""
    h = torch.zeros(a.shape[1:], dtype=a.dtype, device=a.device) \
        if h0 is None else h0
    hs = []
    for t in range(a.shape[0]):
        h = a[t] * h + b[t]
        hs.append(h)
    return torch.stack(hs) if hs else torch.empty_like(a)


# ---------------------------------------------------------------------------
# rwkv6 — data-dependent-decay WKV recurrence (one head)
# ---------------------------------------------------------------------------

def rwkv6_recurrence(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     s0: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 "Finch" WKV for a single head.

    r,k,w: [T, K], v: [T, V], u: [K].  State S: [K, V].
      o_t = (S_{t-1} + (u * k_t)^T v_t)^T r_t
      S_t = diag(w_t) S_{t-1} + k_t^T v_t
    Returns (o: [T, V], S_T).
    """
    T, K = r.shape
    V = v.shape[1]
    out_dtype = v.dtype
    f32 = torch.float32
    S = torch.zeros((K, V), dtype=f32, device=r.device) if s0 is None \
        else s0.to(f32)
    r, k, v, w, u = (t.to(f32) for t in (r, k, v, w, u))
    os = []
    for t in range(T):
        kv = k[t][:, None] * v[t][None, :]                     # [K, V]
        os.append(((S + u[:, None] * kv) * r[t][:, None]).sum(0))
        S = w[t][:, None] * S + kv
    o = torch.stack(os) if os else torch.zeros((0, V), dtype=f32,
                                                device=r.device)
    return o.to(out_dtype), S
