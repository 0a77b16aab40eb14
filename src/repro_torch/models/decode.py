"""Serving paths: cache init, prefill, and single-token decode.

The port of :mod:`repro.models.decode`.  Caches mirror the stacked-layer
structure: one stacked cache per period position (``[n_periods, B,
...]``) plus unstacked caches for remainder layers.  Cache kinds per
block:

  self/dense_self/moe_self (GQA), dec_self_cross — {k, v: [B, S, Hkv,
           dh]}, the full KV cache
  dense_self/moe_self (MLA) — {c_kv: [B, S, kv_lora], k_rope: [B, S,
           rope]}, the latent cache
  cross  — {} (the context is static: nothing cached)
  rwkv   — {s: [B, H, K, V] f32, x_tok, x_ch: [B, D]}
  lru    — {h: [B, W] f32, conv: [B, cw-1, W]}
  window — ring buffer {k, v: [B, S, Hkv, dh], pos: [B, S] int32 (-1 =
           empty)}, S = min(window, seq)

``decode_step`` walks the stacked layers in a Python loop (the reference
scans them); a MoE stack runs its remainder (the leading dense layers)
first, every other stack last, as the reference does.  An encdec
decoder adds its learned position at ``index``; the cross attentions
read ``context`` (the encoded audio, the image embeddings) at every
step.  ``prefill`` takes the reference's routes: a pure-GQA stack one
batched forward pass (:func:`_prefill_gqa_fast`) that also writes every
layer's keys and values; a stack with MoE, MLA or cross layers T decode
steps (the reference's loop).  The ``ssm`` and ``hybrid`` stacks take the
whole prompt through each layer in turn — one ``rwkv6_recurrence`` or
``rglru_scan`` launch per recurrent layer, the causal + window mask over
the prompt for a window layer — which computes what the reference's T
decode steps from position 0 compute.  Both update the cache IN PLACE
and return it: the counterpart of the reference engine's donated cache.
A caller that needs the cache as it was clones it first
(``tree_map(torch.clone, cache)``).

Under a tensor-parallel hook inside a mesh (:mod:`repro_torch.serve.
collectives`) params and caches are rank-stacked slices and the
activations carry the rank dims; ``rank0=True`` takes rank 0's hidden
state before the final norm and head, so the logits are one ``[B, V]``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import parallel as TP
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    ATTENTION_KINDS, _attn_kw, _gated, _norm, _period_of, apply_block,
    layer_views, logits, rank0, ranked, rem_first)

PyTree = Any


def _block_cache(cfg: ModelConfig, kind: str, batch: int, seq: int,
                 dtype=torch.bfloat16, *, device="cpu",
                 lead: tuple[int, ...] = ()) -> PyTree:
    if kind in ("dense_self", "moe_self") and cfg.mla is not None:
        return MLA.init_mla_cache(batch, seq, cfg.mla, dtype, device=device,
                                  lead=lead)
    if kind in ATTENTION_KINDS + ("enc_self", "dec_self_cross"):
        return A.init_gqa_cache(batch, seq, cfg.n_kv_heads, cfg.head_dim,
                                dtype, device=device, lead=lead)
    if kind == "cross":
        return {}                   # the context is static: nothing cached
    if kind == "rwkv":
        return RW.init_rwkv6_cache(batch, cfg.d_model, dtype, device=device,
                                   lead=lead)
    if kind == "window":
        return A.init_window_cache(batch, min(cfg.hybrid.window, seq),
                                   cfg.n_kv_heads, cfg.head_dim, dtype,
                                   device=device, lead=lead)
    if kind == "lru":
        return RG.init_rglru_cache(batch, cfg.hybrid, cfg.d_model, dtype,
                                   device=device, lead=lead)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               dtype=torch.bfloat16, *, device="cpu") -> PyTree:
    period, n_periods, rem = _period_of(cfg)
    return {"layers": {f"pos{j}_{kind}": _block_cache(
                cfg, kind, batch, seq, dtype, device=device,
                lead=(n_periods,)) for j, kind in enumerate(period)},
            "rem": {f"rem{j}_{kind}": _block_cache(
                cfg, kind, batch, seq, dtype, device=device)
                for j, kind in enumerate(rem)}}


def _layers(params: PyTree, cache: PyTree, cfg: ModelConfig):
    """``(params, cache, kind)`` of every layer in depth order: the
    stacked periods and the remainder, the remainder first in a MoE
    stack (its leading dense layers) and last in every other."""
    period, _, _ = _period_of(cfg)
    rem = [(params["rem"][name], cache["rem"][name], name.split("_", 1)[1])
           for name in sorted(cache["rem"])]
    if rem_first(cfg):
        yield from rem
    hook = TP.current()
    for pp, cc in zip(layer_views(params["layers"]),
                      layer_views(cache["layers"])):
        if hook is not None:
            pp = hook.layer_params(pp, ("layers",))
        for j, kind in enumerate(period):
            name = f"pos{j}_{kind}"
            yield pp[name], cc[name], kind
    if not rem_first(cfg):
        yield from rem


# Cache leaves the reference replaces by the step's activations (the conv
# window ends with x_t, a token shift is x_t): by jnp's type promotion they
# take x's dtype after the first step, while rings (written through
# ``.astype``) and the f32 states keep theirs.
_FOLLOW_X = {"lru": ("conv",), "rwkv": ("x_tok", "x_ch")}


def _follow_activations_(cache: PyTree, dtype: torch.dtype) -> None:
    """Widen, once, the leaves of :data:`_FOLLOW_X` to the promotion of
    their dtype and the activations' ``dtype`` (a no-op once they hold
    it): the port writes them in place, where the reference's update
    would have promoted them."""
    for part in ("layers", "rem"):
        for name, c in cache[part].items():
            for key in _FOLLOW_X.get(name.split("_", 1)[1], ()):
                want = torch.promote_types(c[key].dtype, dtype)
                if c[key].dtype != want:
                    c[key] = c[key].to(want)


def _window_kw(cfg: ModelConfig) -> dict:
    return dict(_attn_kw(cfg), window=cfg.hybrid.window)


def _norms(p, cfg):
    return (lambda z: _norm(p["ln1"], z, cfg),
            lambda z: _norm(p["ln2"], z, cfg))


# ---------------------------------------------------------------------------
# single-block decode and prefill
# ---------------------------------------------------------------------------

def block_decode(p: PyTree, x: torch.Tensor, cache: PyTree, index,
                 cfg: ModelConfig, kind: str, *, context=None,
                 use_kernels: bool = True) -> tuple[torch.Tensor, PyTree]:
    """One token x [..., B, 1, D] through one block; ``index`` (scalar or
    per-row [B]) is read by the attention and window layers, ``context``
    by the cross attentions (``cross``, ``dec_self_cross``: without one
    they attend to the token itself, as the reference's do)."""
    akw = _attn_kw(cfg)
    if kind in ATTENTION_KINDS:
        tp = TP.current()
        xin = _norm(p["ln1"], x, cfg)
        if kind != "self" and cfg.mla is not None:
            h, cache = MLA.mla_decode(p["attn"], xin, cache, index,
                                      n_heads=cfg.n_heads, cfg=cfg.mla,
                                      rope_theta=cfg.rope_theta)
        else:
            h, cache = A.gqa_decode(p["attn"], xin, cache, index, **akw)
        if tp is not None:
            h = tp.attn_reduce(h)
        x = x + h
        if kind == "moe_self":
            y, _ = MOE.moe_ffn(p["moe"], _norm(p["ln2"], x, cfg), cfg.moe,
                               cfg.activation)
            return x + y, cache
        f = L.ffn(p["ffn"], _norm(p["ln2"], x, cfg), cfg.activation)
        if tp is not None:
            f = tp.ffn_reduce(f)
        return x + f, cache
    if kind == "rwkv":
        return RW.rwkv6_decode(p["tok"], p["ch"], x, cache, *_norms(p, cfg),
                               use_kernels=use_kernels)
    if kind == "cross":
        h = A.gqa_attention(p["attn"], _norm(p["ln1"], x, cfg),
                            context=context, causal=False,
                            chunk=cfg.attn_chunk, **akw)
        x = x + _gated(p["gate_attn"], h, x.dtype)
        f = L.ffn(p["ffn"], _norm(p["ln2"], x, cfg), cfg.activation)
        return x + _gated(p["gate_ffn"], f, x.dtype), cache
    if kind == "dec_self_cross":
        h, cache = A.gqa_decode(p["attn"], _norm(p["ln1"], x, cfg), cache,
                                index, use_rope=False, **akw)
        x = x + h
        h = A.gqa_attention(p["xattn"], _norm(p["ln_x"], x, cfg),
                            context=context, causal=False, use_rope=False,
                            chunk=cfg.attn_chunk, **akw)
    elif kind == "window":
        h, cache = A.window_decode(p["attn"], _norm(p["ln1"], x, cfg), cache,
                                   index, **_window_kw(cfg))
    elif kind == "lru":
        h, cache = RG.rglru_decode(p["mixer"], _norm(p["ln1"], x, cfg),
                                   cache, use_kernels=use_kernels)
    else:
        raise ValueError(kind)
    x = x + h
    x = x + L.ffn(p["ffn"], _norm(p["ln2"], x, cfg), cfg.activation)
    return x, cache


def block_prefill(p: PyTree, x: torch.Tensor, cache: PyTree,
                  cfg: ModelConfig, kind: str, *, use_kernels: bool = True
                  ) -> tuple[torch.Tensor, PyTree]:
    """A whole prompt x [B, T, D] through one recurrent or window block
    (window layers from position 0)."""
    if kind == "rwkv":
        return RW.rwkv6_prefill(p["tok"], p["ch"], x, cache,
                                *_norms(p, cfg), use_kernels=use_kernels)
    if kind == "window":
        h, cache = A.window_prefill(p["attn"], _norm(p["ln1"], x, cfg),
                                    cache, chunk=cfg.attn_chunk,
                                    **_window_kw(cfg))
    elif kind == "lru":
        h, cache = RG.rglru_prefill(p["mixer"], _norm(p["ln1"], x, cfg),
                                    cache, use_kernels=use_kernels)
    else:
        raise ValueError(f"block_prefill runs the recurrent and window "
                         f"kinds, not {kind!r}")
    x = x + h
    x = x + L.ffn(p["ffn"], _norm(p["ln2"], x, cfg), cfg.activation)
    return x, cache


# ---------------------------------------------------------------------------
# decode step and prefill over the whole stack
# ---------------------------------------------------------------------------

def _head(params: PyTree, cfg: ModelConfig, x: torch.Tensor,
          take_rank0: bool) -> torch.Tensor:
    """Final norm and logits of the last position of x [..., B, T, D]:
    [..., B, V] f32 (rank 0's [B, V] with ``take_rank0``)."""
    x = x[..., -1:, :]
    if take_rank0:
        x = rank0(x)
    return logits(params, cfg, _norm(params["final_norm"], x, cfg))[..., 0, :]


def _dec_pos(table: torch.Tensor, index, dev) -> torch.Tensor:
    """An encdec decoder's learned positions at ``index``: [B, 1, D] for a
    per-row [B] index, [1, 1, D] for a scalar."""
    if isinstance(index, int):
        return table[index:index + 1][None]
    idx = torch.as_tensor(index, device=dev).to(torch.int64)
    if idx.dim():
        return table[idx][:, None, :]
    return table.index_select(0, idx.reshape(1))[None]


def decode_step(params: PyTree, cfg: ModelConfig, token: torch.Tensor,
                cache: PyTree, index, *, context=None,
                use_kernels: bool = True, rank0: bool = False
                ) -> tuple[torch.Tensor, PyTree]:
    """token: [B] int; ``index`` scalar or per-row [B] (RoPE, cache slot
    and mask are per row); ``context`` the cross attentions' memory
    (encdec: already encoded).  Returns (logits [B, V] f32, cache), the
    cache updated in place; under a tensor-parallel hook in a mesh the
    logits are every rank's ``[*rank, B, V]``, or rank 0's with
    ``rank0``."""
    period, _, rem = _period_of(cfg)
    x = ranked(L.embed_lookup(params["embed"], token[:, None]))
    if cfg.family == "encdec":
        x = x + _dec_pos(params["dec_pos"], index, x.device).to(x.dtype)
    _follow_activations_(cache, x.dtype)
    if "window" in period + rem:           # one copy to the device
        index = torch.as_tensor(index, device=x.device)
    for p, c, kind in _layers(params, cache, cfg):
        x, _ = block_decode(p, x, c, index, cfg, kind, context=context,
                            use_kernels=use_kernels)
    return _head(params, cfg, x, rank0), cache


def prefill(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            cache: PyTree, *, context=None, use_kernels: bool = True,
            rank0: bool = False) -> tuple[torch.Tensor, PyTree]:
    """Fill the caches with a whole prompt [B, T] from position 0;
    returns (last_logits, cache), the cache updated in place.

    The reference's routes: a pure-GQA stack (``self``/``dense_self``, no
    MLA) takes :func:`_prefill_gqa_fast`, its batched pass; every stack
    with MoE, MLA or cross layers T decode steps (the reference's loop:
    MoE capacity and drops are those of single-token decode, and every
    step reads ``context``).  In the recurrent and window stacks each
    layer takes the whole prompt at once (:func:`block_prefill`):
    recurrent layers continue their cached state with one kernel launch
    over T, window layers attend from position 0 (the reference's prefill
    starts every sequence there); it computes what T decode steps from
    position 0 compute.
    """
    period, _, rem = _period_of(cfg)
    kinds = set(period) | set(rem)
    if kinds <= {"self", "dense_self"} and cfg.mla is None:
        return _prefill_gqa_fast(params, cfg, tokens, cache, rank0=rank0)
    if not kinds <= {"rwkv", "lru", "window"}:
        b, t = tokens.shape
        lg = torch.zeros((b, cfg.vocab), dtype=torch.float32,
                         device=tokens.device)
        for i in range(t):
            lg, cache = decode_step(params, cfg, tokens[:, i], cache, i,
                                    context=context,
                                    use_kernels=use_kernels, rank0=rank0)
        return lg, cache
    x = L.embed_lookup(params["embed"], tokens)
    _follow_activations_(cache, x.dtype)
    for p, c, kind in _layers(params, cache, cfg):
        x, _ = block_prefill(p, x, c, cfg, kind, use_kernels=use_kernels)
    return _head(params, cfg, x, rank0), cache


def _prefill_gqa_fast(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: PyTree, *, rank0: bool = False
                      ) -> tuple[torch.Tensor, PyTree]:
    """Batched prefill for homogeneous GQA stacks: the forward pass
    (:func:`repro_torch.models.transformer.apply_block` per layer) that
    also projects every layer's K/V once more for the cache, written to
    positions ``[0, T)`` in place; returns the last token's logits."""
    t = tokens.shape[1]
    x = ranked(L.embed_lookup(params["embed"], tokens))
    pos = torch.arange(t, device=x.device)[None]
    for p, c, kind in _layers(params, cache, cfg):
        xin = _norm(p["ln1"], x, cfg)
        _, k, v = A._project_qkv(p["attn"], xin, xin, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim, cfg.qk_norm,
                                 cfg.rope_theta, pos, pos)
        x, _ = apply_block(p, x, cfg, kind)
        c["k"][..., :t, :, :] = k.to(c["k"].dtype)
        c["v"][..., :t, :, :] = v.to(c["v"].dtype)
    return _head(params, cfg, x, rank0), cache
