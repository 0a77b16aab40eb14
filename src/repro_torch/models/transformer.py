"""Model assembly: blocks per family, the stacked layer layout, logits.

The part of :mod:`repro.models.transformer` the serving paths of the
``ssm`` (RWKV-6) and ``hybrid`` (RG-LRU + window attention) families
need.  Params keep the reference's tree: ``embed``, ``final_norm``,
``lm_head`` (untied), ``layers`` — one entry per position of the
repeating period, each leaf stacked ``[n_periods, ...]`` — and ``rem``,
the unstacked remainder.  Init takes an explicit ``torch.Generator`` and
a device; the stacked leaves are drawn in one go (``lead=(n,)``), with the
reference's distributions and dtypes leaf by leaf.  Block kinds other
than ``rwkv``, ``lru`` and ``window``, and the training forward, wait for
their ROADMAP.md items (queue 1 items 6-7).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models.config import ModelConfig

PyTree = Any


PORTED_KINDS = ("rwkv", "lru", "window")


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet: the port runs the ssm "
        f"family ('rwkv') and the hybrid family ('lru', 'window'); the "
        f"dense, moe, encdec and vlm kinds wait for ROADMAP.md queue 1 "
        f"item 6")


# ---------------------------------------------------------------------------
# block init (one layer, or n stacked with lead=(n,))
# ---------------------------------------------------------------------------

def init_block(gen, cfg: ModelConfig, kind: str, *, device="cpu",
               lead: tuple[int, ...] = ()) -> PyTree:
    """kind ∈ {rwkv, lru, window}; the reference's other kinds raise."""
    dt = L._dtype(cfg.param_dtype)
    d = cfg.d_model
    if kind not in PORTED_KINDS:
        raise _not_ported(kind)
    norm = dict(device=device, lead=lead)
    p = {"ln1": L.init_norm(d, cfg.norm, **norm),
         "ln2": L.init_norm(d, cfg.norm, **norm)}
    if kind == "rwkv":
        p["tok"] = RW.init_rwkv6(gen, d, dt, **norm)
        p["ch"] = RW.init_channel_mix(gen, d, cfg.d_ff, dt, **norm)
        return p
    if kind == "window":
        p["attn"] = A.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, cfg.qk_norm, dt, **norm)
    else:
        p["mixer"] = RG.init_rglru(gen, d, cfg.hybrid, dt, **norm)
    p["ffn"] = L.init_ffn(gen, d, cfg.d_ff, cfg.activation, dt, **norm)
    return p


def _norm(p, x, cfg):
    return L.apply_norm(p, x, eps=cfg.norm_eps)


# ---------------------------------------------------------------------------
# layer-stack schedules (which kind at which depth)
# ---------------------------------------------------------------------------

def layer_schedule(cfg: ModelConfig) -> list[str]:
    if cfg.family == "dense":
        return ["self"] * cfg.n_layers
    if cfg.family == "moe":
        lead = cfg.moe.first_dense_layers
        return ["dense_self"] * lead + ["moe_self"] * (cfg.n_layers - lead)
    if cfg.family == "hybrid":
        pat = list(cfg.hybrid.pattern)
        return [("window" if pat[i % len(pat)] == "attn" else "lru")
                for i in range(cfg.n_layers)]
    if cfg.family == "ssm":
        return ["rwkv"] * cfg.n_layers
    if cfg.family == "encdec":
        return ["dec_self_cross"] * cfg.n_layers
    if cfg.family == "vlm":
        k = cfg.vlm.cross_every
        return [("cross" if i % k == 0 else "self")
                for i in range(cfg.n_layers)]
    raise ValueError(cfg.family)


def _period_of(cfg: ModelConfig) -> tuple[list[str], int, list[str]]:
    """(period_kinds, n_periods, remainder_kinds)."""
    sched = layer_schedule(cfg)
    if cfg.family == "hybrid":
        period = [("window" if p == "attn" else p)
                  for p in cfg.hybrid.pattern]
    elif cfg.family == "vlm":
        k = cfg.vlm.cross_every
        period = ["cross"] + ["self"] * (k - 1)
    elif cfg.family == "moe" and cfg.moe.first_dense_layers:
        # leading dense layers are the remainder-prefix; period is moe
        n = cfg.n_layers - cfg.moe.first_dense_layers
        return ["moe_self"], n, sched[:cfg.moe.first_dense_layers]
    else:
        return [sched[0]], cfg.n_layers, []
    n_periods = cfg.n_layers // len(period)
    rem = sched[n_periods * len(period):]
    return period, n_periods, rem


# ---------------------------------------------------------------------------
# stack init
# ---------------------------------------------------------------------------

def init_stack(gen, cfg: ModelConfig, *, device="cpu") -> PyTree:
    dt = L._dtype(cfg.param_dtype)
    period, n_periods, rem = _period_of(cfg)
    p: dict = {
        "embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dt,
                              device=device),
        "final_norm": L.init_norm(cfg.d_model, cfg.norm, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab, dt,
                                    device=device)
    p["layers"] = {f"pos{j}_{kind}": init_block(gen, cfg, kind,
                                                device=device,
                                                lead=(n_periods,))
                   for j, kind in enumerate(period)}
    p["rem"] = {f"rem{j}_{kind}": init_block(gen, cfg, kind, device=device)
                for j, kind in enumerate(rem)}
    if cfg.family == "encdec":
        raise _not_ported("enc_self")
    return p


def logits(params: PyTree, cfg: ModelConfig,
           hidden: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.logits_head(hidden, w)
