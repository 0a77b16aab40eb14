"""Attention: GQA flash-attention (KV-chunked, online softmax), the GQA
layer, and sliding-window serving with a ring-buffer cache.

The part of :mod:`repro.models.attention` the hybrid family's serving
path needs.  ``flash_attention`` is the reference's KV-chunked online
softmax (f32 statistics, causal and window masks, a scalar or per-row
``q_offset``, an optional valid-KV prefix).  Attention has no Pallas
kernel in the reference.  On the card, the calls
:func:`repro_torch.kernels.flash_attention.takes` names (full sequences:
an int ``q_offset``, no ``kv_len``, bf16 operands with one head dim,
``d <= 128``) run the port's fused kernel, forward and backward, at the
plain form's f32 accuracy.  The rest (the decode forms with ``kv_len`` or a
per-row ``q_offset``, MLA's ``d != dv``) and every CPU call keep the
plain loop (:func:`plain_flash_attention`): the reference's ``lax.scan``
over KV blocks written as a Python loop of PyTorch products and a masked
f32 softmax.  While spans are recorded, each call on the card counts
``kernel.attention.calls`` or ``attention.plain_calls``.

Serving with a window (``window_decode``, ``window_prefill``) keeps the
last ``window`` keys and values in a ring: slot ``pos % window`` holds
position ``pos``, and the cache's ``pos`` buffer (-1 = empty) masks what a
query may see: ``0 <= pos <= index`` and ``pos > index - window``.  A
cache may hold fewer slots than the window (``min(window, seq)``, as the
reference's ``init_cache`` sizes it); then every position it is asked to
hold is below its slot count.  Both functions write the cache in place.

The dense and MoE families keep a full KV cache (``init_gqa_cache``,
``gqa_decode``): the token's key and value go to position ``index`` of
each row, in place, and the query attends over the valid prefix.  The
attention functions take any leading dims before ``[B, T, ...]``: under
tensor parallelism (:mod:`repro_torch.serve.collectives`) activations,
sliced weights and caches carry the rank dim in front, and one call
serves every rank (:func:`repro_torch.models.layers.dense`).
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as L
from repro_torch.obs import metrics as _metrics
from repro_torch.sharding.act import shard_act

PyTree = Any
NEG_INF = -1e30


def _gqa_expand(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[..., T, Hq, d] -> [..., T, Hkv, G, d]."""
    hq, d = q.shape[-2:]
    return q.reshape(q.shape[:-2] + (n_kv, hq // n_kv, d))


def flash_attention(
    q: torch.Tensor,            # [..., B, Tq, Hq, d]
    k: torch.Tensor,            # [..., B, Tk, Hkv, d]
    v: torch.Tensor,            # [..., B, Tk, Hkv, dv]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset=0,
    kv_len=None,                # valid KV prefix (decode masking)
    chunk: int = 1024,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """``q_offset`` and ``kv_len`` are scalars or per-row [B] vectors
    (continuous batching: every row at its own position).  Leading dims
    before B broadcast (the rank dim under tensor parallelism).  Returns
    [..., B, Tq, Hq, dv] in v's dtype.  The fused kernel takes the calls
    :func:`repro_torch.kernels.flash_attention.takes` names (``chunk``
    does not matter there); the plain loop the rest."""
    scale = softmax_scale if softmax_scale is not None \
        else 1.0 / math.sqrt(q.shape[-1])
    rec = _metrics.RECORDER
    if FA.takes(q, k, v, causal=causal, window=window, q_offset=q_offset,
                kv_len=kv_len):
        if rec.spans is not None:
            rec.count("kernel.attention.calls")
        return FA.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, scale=scale)
    if q.is_cuda and rec.spans is not None:
        rec.count("attention.plain_calls")
    return plain_flash_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, kv_len=kv_len,
                                 chunk=chunk, scale=scale)


def plain_flash_attention(q, k, v, *, causal: bool, window: Optional[int],
                          q_offset, kv_len, chunk: int,
                          scale: float) -> torch.Tensor:
    """The plain loop of :func:`flash_attention`: KV chunks of ``chunk``
    keys (the last padded), f32 scores and an online softmax."""
    tq = q.shape[-3]
    tk, hkv, dv = v.shape[-3:]
    dev = q.device
    qf = _gqa_expand(q.to(torch.float32) * scale, hkv)    # [..,Tq,Hkv,G,d]

    chunk = min(chunk, tk)
    nkc = -(-tk // chunk)
    q_pos = torch.arange(tq, device=dev)
    if isinstance(q_offset, int):       # no host-to-device copy
        q_pos = (q_pos + q_offset)[None]
    else:
        q_pos = (torch.as_tensor(q_offset, device=dev).to(torch.int64)
                 [..., None] + q_pos).reshape(-1, tq)     # [1 or B, Tq]
    kl = None if kv_len is None else \
        torch.as_tensor(kv_len, device=dev).to(torch.int64).reshape(-1, 1)

    m = l_ = acc = None
    for ci in range(nkc):
        k_pos = ci * chunk + torch.arange(chunk, device=dev)       # [C]
        kc = k[..., ci * chunk:(ci + 1) * chunk, :, :].to(torch.float32)
        vc = v[..., ci * chunk:(ci + 1) * chunk, :, :].to(torch.float32)
        if kc.shape[-3] < chunk:                # the ragged last chunk
            pad = chunk - kc.shape[-3]
            kc = torch.nn.functional.pad(kc, (0, 0, 0, 0, 0, pad))
            vc = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, pad))
        s = torch.einsum("...qhgd,...chd->...qhgc", qf, kc)  # [..,Tq,Hkv,G,C]
        mask = (k_pos < tk)[None, None, :]                 # [1, 1, C]
        if kl is not None:
            mask = mask & (k_pos[None, :] < kl)[:, None, :]
        if causal:
            mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])
        if window is not None:
            mask = mask & (k_pos[None, None, :] > q_pos[:, :, None] - window)
        s = s.masked_fill(~mask[:, :, None, None, :], NEG_INF)
        if m is None:
            m = torch.full(s.shape[:-1], NEG_INF, dtype=torch.float32,
                           device=dev)
            l_ = torch.zeros_like(m)
            acc = torch.zeros(s.shape[:-1] + (dv,), dtype=torch.float32,
                              device=dev)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_ = l_ * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("...qhgc,...chv->...qhgv",
                                                   p, vc)
        m = m_new
    out = acc / l_.clamp_min(1e-30)[..., None]
    return out.reshape(out.shape[:-3] + (q.shape[-2], dv)).to(v.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer (params + apply)
# ---------------------------------------------------------------------------

def init_gqa(gen, d_model: int, n_heads: int, n_kv: int, d_head: int,
             qk_norm: bool = False, dtype=torch.bfloat16, *, device="cpu",
             lead: tuple[int, ...] = ()) -> PyTree:
    dense = dict(device=device, lead=lead)
    p = {
        "wq": L.dense_init(gen, d_model, n_heads * d_head, dtype, **dense),
        "wk": L.dense_init(gen, d_model, n_kv * d_head, dtype, **dense),
        "wv": L.dense_init(gen, d_model, n_kv * d_head, dtype, **dense),
        "wo": L.dense_init(gen, n_heads * d_head, d_model, dtype, **dense),
    }
    if qk_norm:
        p["q_norm"] = L.init_rmsnorm(d_head, device=device, lead=lead)
        p["k_norm"] = L.init_rmsnorm(d_head, device=device, lead=lead)
    return p


def _heads(y: torch.Tensor, n: int, d_head: int) -> torch.Tensor:
    """[..., T, n * d_head] -> [..., T, n, d_head]."""
    return y.reshape(y.shape[:-1] + (n, d_head))


def _project_qkv(p, x, xc, n_heads, n_kv, d_head, qk_norm, rope_theta,
                 q_positions, k_positions, use_rope=True):
    """x, xc: [..., B, T, D]; positions [1 or B, T]."""
    q = _heads(L.dense(x, p["wq"]), n_heads, d_head)
    k = _heads(L.dense(xc, p["wk"]), n_kv, d_head)
    v = _heads(L.dense(xc, p["wv"]), n_kv, d_head)
    if qk_norm:
        q = L.rmsnorm(p["q_norm"], q)
        k = L.rmsnorm(p["k_norm"], k)
    if use_rope:
        q = L.apply_rope(q, q_positions, rope_theta)
        k = L.apply_rope(k, k_positions, rope_theta)
    q = shard_act(q, "dp", None, "tp", None)
    k = shard_act(k, "dp", None, "tp", None)
    v = shard_act(v, "dp", None, "tp", None)
    return q, k, v


def gqa_attention(
    p: PyTree, x: torch.Tensor, *, n_heads: int, n_kv: int, d_head: int,
    causal: bool = True, window: Optional[int] = None, qk_norm: bool = False,
    rope_theta: float = 10000.0, q_offset: int = 0, chunk: int = 1024,
    context: Optional[torch.Tensor] = None, use_rope: bool = True,
) -> torch.Tensor:
    """Self (context=None) or cross attention over full sequences
    x [..., B, T, D]."""
    xc = x if context is None else context
    t = x.shape[-2]
    q_pos = q_offset + torch.arange(t, device=x.device)
    k_pos = torch.arange(xc.shape[-2], device=x.device)
    q, k, v = _project_qkv(p, x, xc, n_heads, n_kv, d_head, qk_norm,
                           rope_theta, q_pos[None], k_pos[None],
                           use_rope=use_rope and context is None)
    out = flash_attention(q, k, v, causal=causal and context is None,
                          window=window, q_offset=q_offset, chunk=chunk)
    return L.dense(out.reshape(out.shape[:-2] + (n_heads * d_head,)),
                   p["wo"])


# ---------------------------------------------------------------------------
# single-token decode against a full KV cache (dense, moe)
# ---------------------------------------------------------------------------

def gqa_decode(
    p: PyTree, x: torch.Tensor, cache: PyTree, index, *,
    n_heads: int, n_kv: int, d_head: int, window: Optional[int] = None,
    qk_norm: bool = False, rope_theta: float = 10000.0,
    use_rope: bool = True,
) -> tuple[torch.Tensor, PyTree]:
    """One-token decode.  x: [..., B, 1, D]; cache: {k, v: [..., B, S,
    Hkv, d]}, written in place.

    ``index`` is a scalar (lockstep batch: an int, or a 0-dim tensor) or
    an integer [B] tensor (continuous batching: per-row positions; the
    cache writes are per-row scatters and the masks per row)."""
    b = x.shape[-3]
    dev = x.device
    vec = torch.is_tensor(index) and index.dim() > 0
    if vec:
        idx = index.to(device=dev, dtype=torch.int64)
        pos = idx[:, None]
    elif isinstance(index, int):
        idx = index
        pos = torch.full((b, 1), index, dtype=torch.int64, device=dev)
    else:
        idx = torch.as_tensor(index, device=dev).to(torch.int64)
        pos = idx.reshape(1, 1).expand(b, 1)
    q, k_new, v_new = _project_qkv(
        p, x, x, n_heads, n_kv, d_head, qk_norm, rope_theta, pos, pos,
        use_rope=use_rope)
    kc, vc = cache["k"], cache["v"]
    if vec:
        rows = torch.arange(b, device=dev)
        kc[..., rows, idx, :, :] = k_new[..., 0, :, :].to(kc.dtype)
        vc[..., rows, idx, :, :] = v_new[..., 0, :, :].to(vc.dtype)
    elif isinstance(idx, int):
        kc[..., idx:idx + 1, :, :] = k_new.to(kc.dtype)
        vc[..., idx:idx + 1, :, :] = v_new.to(vc.dtype)
    else:
        kc.index_copy_(kc.dim() - 3, idx.reshape(1), k_new.to(kc.dtype))
        vc.index_copy_(vc.dim() - 3, idx.reshape(1), v_new.to(vc.dtype))
    out = flash_attention(q, kc, vc, causal=False, window=window,
                          q_offset=idx, kv_len=idx + 1,
                          chunk=min(4096, kc.shape[-3]))
    y = L.dense(out.reshape(out.shape[:-2] + (n_heads * d_head,)), p["wo"])
    return y, cache


def init_gqa_cache(batch: int, seq: int, n_kv: int, d_head: int,
                   dtype=torch.bfloat16, *, device="cpu",
                   lead: tuple[int, ...] = ()) -> PyTree:
    shape = lead + (batch, seq, n_kv, d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# sliding-window serving with a ring-buffer cache — O(window) state
# ---------------------------------------------------------------------------

def init_window_cache(batch: int, window: int, n_kv: int, d_head: int,
                      dtype=torch.bfloat16, *, device="cpu",
                      lead: tuple[int, ...] = ()) -> PyTree:
    shape = lead + (batch, window, n_kv, d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full(lead + (batch, window), -1, dtype=torch.int32,
                              device=device)}


def window_decode(
    p: PyTree, x: torch.Tensor, cache: PyTree, index, *,
    n_heads: int, n_kv: int, d_head: int, window: int,
    qk_norm: bool = False, rope_theta: float = 10000.0,
) -> tuple[torch.Tensor, PyTree]:
    """One-token decode against the ring of the last ``window`` KVs.

    x: [B, 1, D]; ``index``: scalar or per-row [B] (continuous batching).
    The token's key and value go to slot ``index % window`` of each row,
    in place; a slot past the cache's own count (a position the cache was
    not sized for) is dropped, as the reference's scatter drops it."""
    b = x.shape[0]
    idx = torch.as_tensor(index, device=x.device).to(torch.int64).expand(b)
    pos = idx[:, None]
    q, k_new, v_new = _project_qkv(
        p, x, x, n_heads, n_kv, d_head, qk_norm, rope_theta, pos, pos)
    n_slots = cache["k"].shape[1]
    slot = idx % window
    keep = slot < n_slots
    slot = slot.clamp(max=n_slots - 1)
    rows = torch.arange(b, device=x.device)
    for name, new in (("k", k_new[:, 0]), ("v", v_new[:, 0]),
                      ("pos", idx)):
        buf = cache[name]
        old = buf[rows, slot]
        buf[rows, slot] = torch.where(
            keep.reshape((b,) + (1,) * (old.dim() - 1)), new.to(buf.dtype),
            old)

    scale = 1.0 / math.sqrt(d_head)
    qe = _gqa_expand(q.to(torch.float32) * scale, n_kv)  # [B,1,Hkv,G,d]
    s = torch.einsum("bqhgd,bwhd->bqhgw", qe, cache["k"].to(torch.float32))
    slot_pos = cache["pos"].to(torch.int64)
    valid = ((slot_pos >= 0) & (slot_pos <= idx[:, None])
             & (slot_pos > idx[:, None] - window))           # [B, W]
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgw,bwhv->bqhgv", a, cache["v"].to(torch.float32))
    y = out.reshape(b, 1, n_heads * d_head).to(x.dtype) @ p["wo"]
    return y, cache


def window_prefill(
    p: PyTree, x: torch.Tensor, cache: PyTree, *,
    n_heads: int, n_kv: int, d_head: int, window: int,
    qk_norm: bool = False, rope_theta: float = 10000.0, chunk: int = 1024,
) -> tuple[torch.Tensor, PyTree]:
    """A whole prompt [B, T, D] from position 0: what T calls of
    :func:`window_decode` on an empty ring compute.

    Every query attends over the prompt with the causal + window mask
    (:func:`flash_attention`); then the ring is emptied and the last
    ``min(slots, T)`` keys and values are written to slots ``pos %
    window``, their positions into ``pos``, in place.  A ring sized below
    the window (``min(window, seq)`` slots) must hold the whole prompt."""
    b, t, _ = x.shape
    n_slots = cache["k"].shape[1]
    if n_slots < window and t > n_slots:
        raise ValueError(f"a prompt of {t} tokens does not fit a window "
                         f"cache of {n_slots} slots (window {window})")
    pos = torch.arange(t, device=x.device)[None]
    q, k, v = _project_qkv(p, x, x, n_heads, n_kv, d_head, qk_norm,
                           rope_theta, pos, pos)
    out = flash_attention(q, k, v, causal=True, window=window, chunk=chunk)
    y = out.reshape(b, t, n_heads * d_head).to(x.dtype) @ p["wo"]

    m = min(n_slots, t)
    kept = torch.arange(t - m, t, device=x.device)
    slot = kept % window
    cache["k"][:, slot] = k[:, t - m:].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, t - m:].to(cache["v"].dtype)
    cache["pos"].fill_(-1)
    cache["pos"][:, slot] = kept.to(torch.int32)
    return y, cache
