"""Serving paths: cache init, prefill, and single-token decode.

The part of :mod:`repro.models.decode` the ``ssm`` and ``hybrid``
families need.  Caches mirror the stacked-layer structure: one stacked
cache per period position (``[n_periods, B, ...]``) plus unstacked caches
for remainder layers.  Cache kinds per block:

  rwkv   — {s: [B, H, K, V] f32, x_tok, x_ch: [B, D]}
  lru    — {h: [B, W] f32, conv: [B, cw-1, W]}
  window — ring buffer {k, v: [B, S, Hkv, dh], pos: [B, S] int32 (-1 =
           empty)}, S = min(window, seq)

``decode_step`` walks the stacked layers in a Python loop (the reference
scans them), then the remainder.  ``prefill`` runs the whole prompt
through each layer in turn — one ``rwkv6_recurrence`` or ``rglru_scan``
launch per recurrent layer, the causal + window mask over the prompt for
a window layer — where the reference runs T decode steps.  Both update
the cache IN PLACE and return it: the counterpart of the reference
engine's donated cache.  A caller that needs the cache as it was clones
it first (``tree_map(torch.clone, cache)``).  Full KV caches (the dense,
moe, encdec and vlm kinds) wait for their families (ROADMAP.md queue 1
item 6).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import PORTED_KINDS, _not_ported, \
    _norm, _period_of, logits

PyTree = Any


def _block_cache(cfg: ModelConfig, kind: str, batch: int, seq: int,
                 dtype=torch.bfloat16, *, device="cpu",
                 lead: tuple[int, ...] = ()) -> PyTree:
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
    raise _not_ported(kind)


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               dtype=torch.bfloat16, *, device="cpu") -> PyTree:
    period, n_periods, rem = _period_of(cfg)
    return {"layers": {f"pos{j}_{kind}": _block_cache(
                cfg, kind, batch, seq, dtype, device=device,
                lead=(n_periods,)) for j, kind in enumerate(period)},
            "rem": {f"rem{j}_{kind}": _block_cache(
                cfg, kind, batch, seq, dtype, device=device)
                for j, kind in enumerate(rem)}}


def _ported_stack(cfg: ModelConfig) -> tuple[list[str], int, list[str]]:
    """:func:`_period_of`, raising for a kind the port does not run."""
    period, n_periods, rem = _period_of(cfg)
    for kind in period + rem:
        if kind not in PORTED_KINDS:
            raise _not_ported(kind)
    return period, n_periods, rem


def layer_views(stacked: PyTree) -> list[PyTree]:
    """Per-layer views of a stacked ``[n, ...]`` tree: writes through a
    view land in the stacked tensors."""
    leaves, td = tree.tree_flatten(stacked)
    per_leaf = [leaf.unbind(0) for leaf in leaves]
    return [tree.tree_unflatten(td, [p[i] for p in per_leaf])
            for i in range(len(per_leaf[0]))]


def _layers(params: PyTree, cache: PyTree, cfg: ModelConfig):
    """``(params, cache, kind)`` of every layer in depth order: the
    stacked periods, then the remainder (the hybrid and ssm stacks have
    no leading remainder)."""
    period, _, _ = _period_of(cfg)
    for pp, cc in zip(layer_views(params["layers"]),
                      layer_views(cache["layers"])):
        for j, kind in enumerate(period):
            name = f"pos{j}_{kind}"
            yield pp[name], cc[name], kind
    for name in sorted(cache["rem"]):
        yield params["rem"][name], cache["rem"][name], name.split("_", 1)[1]


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


def _attn_kw(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                d_head=cfg.head_dim, qk_norm=cfg.qk_norm,
                rope_theta=cfg.rope_theta, window=cfg.hybrid.window)


def _norms(p, cfg):
    return (lambda z: _norm(p["ln1"], z, cfg),
            lambda z: _norm(p["ln2"], z, cfg))


# ---------------------------------------------------------------------------
# single-block decode and prefill
# ---------------------------------------------------------------------------

def block_decode(p: PyTree, x: torch.Tensor, cache: PyTree, index,
                 cfg: ModelConfig, kind: str, *, use_kernels: bool = True
                 ) -> tuple[torch.Tensor, PyTree]:
    """One token x [B, 1, D] through one block; ``index`` (scalar or
    per-row [B]) is read by window layers."""
    if kind == "rwkv":
        return RW.rwkv6_decode(p["tok"], p["ch"], x, cache, *_norms(p, cfg),
                               use_kernels=use_kernels)
    if kind == "window":
        h, cache = A.window_decode(p["attn"], _norm(p["ln1"], x, cfg), cache,
                                   index, **_attn_kw(cfg))
    elif kind == "lru":
        h, cache = RG.rglru_decode(p["mixer"], _norm(p["ln1"], x, cfg),
                                   cache, use_kernels=use_kernels)
    else:
        raise _not_ported(kind)
    x = x + h
    x = x + L.ffn(p["ffn"], _norm(p["ln2"], x, cfg), cfg.activation)
    return x, cache


def block_prefill(p: PyTree, x: torch.Tensor, cache: PyTree,
                  cfg: ModelConfig, kind: str, *, use_kernels: bool = True
                  ) -> tuple[torch.Tensor, PyTree]:
    """A whole prompt x [B, T, D] through one block (window layers from
    position 0)."""
    if kind == "rwkv":
        return RW.rwkv6_prefill(p["tok"], p["ch"], x, cache,
                                *_norms(p, cfg), use_kernels=use_kernels)
    if kind == "window":
        h, cache = A.window_prefill(p["attn"], _norm(p["ln1"], x, cfg),
                                    cache, chunk=cfg.attn_chunk,
                                    **_attn_kw(cfg))
    elif kind == "lru":
        h, cache = RG.rglru_prefill(p["mixer"], _norm(p["ln1"], x, cfg),
                                    cache, use_kernels=use_kernels)
    else:
        raise _not_ported(kind)
    x = x + h
    x = x + L.ffn(p["ffn"], _norm(p["ln2"], x, cfg), cfg.activation)
    return x, cache


# ---------------------------------------------------------------------------
# decode step and prefill over the whole stack
# ---------------------------------------------------------------------------

def decode_step(params: PyTree, cfg: ModelConfig, token: torch.Tensor,
                cache: PyTree, index, *, use_kernels: bool = True
                ) -> tuple[torch.Tensor, PyTree]:
    """token: [B] int; ``index`` scalar or per-row [B] (read by window
    layers: RoPE, ring slot and mask are per row).  Returns (logits
    [B, V] f32, cache), the cache updated in place."""
    period, _, rem = _ported_stack(cfg)
    x = L.embed_lookup(params["embed"], token[:, None])
    _follow_activations_(cache, x.dtype)
    if "window" in period + rem:           # one copy to the device
        index = torch.as_tensor(index, device=x.device)
    for p, c, kind in _layers(params, cache, cfg):
        x, _ = block_decode(p, x, c, index, cfg, kind,
                            use_kernels=use_kernels)
    x = _norm(params["final_norm"], x, cfg)
    return logits(params, cfg, x)[:, 0, :], cache


def prefill(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            cache: PyTree, *, use_kernels: bool = True
            ) -> tuple[torch.Tensor, PyTree]:
    """Fill the caches with a whole prompt [B, T]; returns (last_logits,
    cache), the cache updated in place.

    Each layer takes the whole prompt at once (:func:`block_prefill`):
    recurrent layers continue their cached state with one kernel launch
    over T, window layers attend from position 0 (the reference's prefill
    starts every sequence there); it computes what T decode steps from
    position 0 compute.
    """
    _ported_stack(cfg)
    x = L.embed_lookup(params["embed"], tokens)
    _follow_activations_(cache, x.dtype)
    for p, c, kind in _layers(params, cache, cfg):
        x, _ = block_prefill(p, x, c, cfg, kind, use_kernels=use_kernels)
    x = _norm(params["final_norm"], x[:, -1:], cfg)
    return logits(params, cfg, x)[:, 0, :], cache
