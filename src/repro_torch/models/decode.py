"""Serving paths: cache init, prefill, and single-token decode.

The part of :mod:`repro.models.decode` the ``ssm`` family needs.  Caches
mirror the stacked-layer structure: one stacked cache per period position
(``[n_periods, B, ...]``) plus unstacked caches for remainder layers.
Cache kind per block:

  rwkv — {s: [B, H, K, V] f32, x_tok, x_ch: [B, D]}

``decode_step`` walks the stacked layers in a Python loop (the reference
scans them) and ``prefill`` runs the whole prompt through each layer in
turn, one ``rwkv6_recurrence`` launch per layer, where the reference runs
T decode steps.  Both update the cache IN PLACE and return it: the
counterpart of the reference engine's donated cache.  A caller that
needs the cache as it was clones it first
(``tree_map(torch.clone, cache)``).  Other cache kinds (KV caches, ring
buffers, RG-LRU state) wait for their families (ROADMAP.md queue 1
item 6).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as RW
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _not_ported, _norm, _period_of, \
    logits

PyTree = Any


def _block_cache(cfg: ModelConfig, kind: str, batch: int, seq: int,
                 dtype=torch.bfloat16, *, device="cpu",
                 lead: tuple[int, ...] = ()) -> PyTree:
    if kind == "rwkv":
        return RW.init_rwkv6_cache(batch, cfg.d_model, dtype, device=device,
                                   lead=lead)
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


def _rwkv_stack(cfg: ModelConfig) -> None:
    period, _, rem = _period_of(cfg)
    for kind in period + rem:
        if kind != "rwkv":
            raise _not_ported(kind)


def layer_views(stacked: PyTree) -> list[PyTree]:
    """Per-layer views of a stacked ``[n, ...]`` tree: writes through a
    view land in the stacked tensors."""
    leaves, td = tree.tree_flatten(stacked)
    per_leaf = [leaf.unbind(0) for leaf in leaves]
    return [tree.tree_unflatten(td, [p[i] for p in per_leaf])
            for i in range(len(per_leaf[0]))]


def _norms(p, cfg):
    return (lambda z: _norm(p["ln1"], z, cfg),
            lambda z: _norm(p["ln2"], z, cfg))


# ---------------------------------------------------------------------------
# single-block decode
# ---------------------------------------------------------------------------

def block_decode(p: PyTree, x: torch.Tensor, cache: PyTree, index,
                 cfg: ModelConfig, kind: str, *, use_kernels: bool = True
                 ) -> tuple[torch.Tensor, PyTree]:
    if kind != "rwkv":
        raise _not_ported(kind)
    return RW.rwkv6_decode(p["tok"], p["ch"], x, cache, *_norms(p, cfg),
                           use_kernels=use_kernels)


# ---------------------------------------------------------------------------
# decode step and prefill over the whole stack
# ---------------------------------------------------------------------------

def decode_step(params: PyTree, cfg: ModelConfig, token: torch.Tensor,
                cache: PyTree, index, *, use_kernels: bool = True
                ) -> tuple[torch.Tensor, PyTree]:
    """token: [B] int; ``index`` scalar or per-row [B] (unread by state
    caches).  Returns (logits [B, V] f32, cache), the cache updated in
    place."""
    _rwkv_stack(cfg)
    period, _, _ = _period_of(cfg)
    x = L.embed_lookup(params["embed"], token[:, None])
    for pp, cc in zip(layer_views(params["layers"]),
                      layer_views(cache["layers"])):
        for j, kind in enumerate(period):
            name = f"pos{j}_{kind}"
            x, _ = block_decode(pp[name], x, cc[name], index, cfg, kind,
                                use_kernels=use_kernels)
    x = _norm(params["final_norm"], x, cfg)
    return logits(params, cfg, x)[:, 0, :], cache


def prefill(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor,
            cache: PyTree, *, use_kernels: bool = True
            ) -> tuple[torch.Tensor, PyTree]:
    """Fill the caches with a whole prompt [B, T]; returns (last_logits,
    cache), the cache updated in place.

    For an all-``rwkv`` stack each layer takes the whole prompt at once
    (:func:`~repro_torch.models.rwkv6.rwkv6_prefill`: one kernel launch
    over T per layer); it computes what T decode steps compute.  Other
    stacks raise.
    """
    _rwkv_stack(cfg)
    period, _, _ = _period_of(cfg)
    x = L.embed_lookup(params["embed"], tokens)
    for pp, cc in zip(layer_views(params["layers"]),
                      layer_views(cache["layers"])):
        for j, kind in enumerate(period):
            name = f"pos{j}_{kind}"
            x, _ = RW.rwkv6_prefill(pp[name]["tok"], pp[name]["ch"], x,
                                    cc[name], *_norms(pp[name], cfg),
                                    use_kernels=use_kernels)
    x = _norm(params["final_norm"], x[:, -1:], cfg)
    return logits(params, cfg, x)[:, 0, :], cache
