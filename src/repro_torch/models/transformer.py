"""Model assembly: blocks per family, the stacked layer layout, logits,
and the inference forward of the attention stacks.

The part of :mod:`repro.models.transformer` the serving paths of the
``dense`` and ``moe`` (GQA attention) families, ``ssm`` (RWKV-6) and
``hybrid`` (RG-LRU + window attention) need.  Params keep the
reference's tree: ``embed``, ``final_norm``, ``lm_head`` (untied),
``layers`` — one entry per position of the repeating period, each leaf
stacked ``[n_periods, ...]`` — and ``rem``, the unstacked remainder (a
MoE stack's leading dense layers, run *before* the periods).  Init takes
an explicit ``torch.Generator`` and a device; the stacked leaves are
drawn in one go (``lead=(n,)``), with the reference's distributions and
dtypes leaf by leaf.

:func:`apply_block` and :func:`forward` are the inference forms of the
reference's (no autograd, no remat) for the ``self``, ``dense_self`` and
``moe_self`` kinds; they consult the tensor-parallel hook
(:mod:`repro_torch.models.parallel`) where the reference does.  MLA
attention (deepseek-v2), the ``encdec`` and ``vlm`` kinds, and the
training forward wait for ROADMAP.md queue 1 items 6 and 7.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree
from repro_torch.mesh import ambient
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import parallel as TP
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models.config import ModelConfig

PyTree = Any


PORTED_KINDS = ("rwkv", "lru", "window", "self", "dense_self", "moe_self")
ATTENTION_KINDS = ("self", "dense_self", "moe_self")


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet: the port runs the dense "
        f"and moe families with GQA attention ('self', 'dense_self', "
        f"'moe_self'), ssm ('rwkv') and hybrid ('lru', 'window'); MLA "
        f"attention (deepseek-v2), encdec (whisper) and vlm (llama "
        f"vision) wait for ROADMAP.md queue 1 item 6")


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise _not_ported(kind)
    if kind in ("dense_self", "moe_self") and cfg.mla is not None:
        raise _not_ported(f"{kind} (MLA)")


# ---------------------------------------------------------------------------
# block init (one layer, or n stacked with lead=(n,))
# ---------------------------------------------------------------------------

def init_block(gen, cfg: ModelConfig, kind: str, *, device="cpu",
               lead: tuple[int, ...] = ()) -> PyTree:
    """kind ∈ {self, dense_self, moe_self (GQA), rwkv, lru, window}; the
    reference's other kinds raise."""
    dt = L._dtype(cfg.param_dtype)
    d = cfg.d_model
    _check_kind(cfg, kind)
    norm = dict(device=device, lead=lead)
    p = {"ln1": L.init_norm(d, cfg.norm, **norm),
         "ln2": L.init_norm(d, cfg.norm, **norm)}
    if kind == "rwkv":
        p["tok"] = RW.init_rwkv6(gen, d, dt, **norm)
        p["ch"] = RW.init_channel_mix(gen, d, cfg.d_ff, dt, **norm)
        return p
    if kind == "lru":
        p["mixer"] = RG.init_rglru(gen, d, cfg.hybrid, dt, **norm)
    else:
        p["attn"] = A.init_gqa(gen, d, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, cfg.qk_norm, dt, **norm)
    if kind == "moe_self":
        p["moe"] = MOE.init_moe(gen, d, cfg.moe, cfg.activation, dt, **norm)
    else:
        d_ff = cfg.moe.d_ff_dense or cfg.d_ff if kind == "dense_self" \
            else cfg.d_ff
        p["ffn"] = L.init_ffn(gen, d, d_ff, cfg.activation, dt, **norm)
    return p


def _norm(p, x, cfg):
    return L.apply_norm(p, x, eps=cfg.norm_eps)


def ranked(x: torch.Tensor) -> torch.Tensor:
    """``x`` with size-1 rank dims in front when a tensor-parallel hook
    runs inside a mesh (the sliced weights then meet every rank's copy,
    :func:`repro_torch.models.layers.dense`); else ``x`` as it is."""
    nd = ambient().rank_ndim
    if nd and TP.current() is not None:
        return x.reshape((1,) * nd + tuple(x.shape))
    return x


def rank0(x: torch.Tensor, nd: int = 3) -> torch.Tensor:
    """Rank 0's copy of a rank-stacked ``[*rank, ...]`` activation whose
    own shape has ``nd`` dims (the copies are equal after the last
    all-reduce); ``x`` itself when it has no rank dims."""
    return x[(0,) * (x.dim() - nd)] if x.dim() > nd else x


def _attn_kw(cfg: ModelConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                d_head=cfg.head_dim, qk_norm=cfg.qk_norm,
                rope_theta=cfg.rope_theta)


def apply_block(p: PyTree, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """One attention block over x [..., B, T, D] from position
    ``q_offset``: causal GQA attention, then the dense FFN or the MoE
    FFN.  Returns (x, aux_loss)."""
    _check_kind(cfg, kind)
    if kind not in ATTENTION_KINDS:
        raise NotImplementedError(
            f"apply_block over {kind!r} is the training forward: ROADMAP.md "
            f"queue 1 item 7 (its serving path is models.decode)")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    tp = TP.current()
    h = A.gqa_attention(p["attn"], _norm(p["ln1"], x, cfg), causal=True,
                        chunk=cfg.attn_chunk, q_offset=q_offset,
                        use_rope=cfg.family != "encdec", **_attn_kw(cfg))
    if tp is not None:
        h = tp.attn_reduce(h)
    x = x + h
    if kind == "moe_self":
        y, aux = MOE.moe_ffn(p["moe"], _norm(p["ln2"], x, cfg), cfg.moe,
                             cfg.activation)
        return x + y, aux
    f = L.ffn(p["ffn"], _norm(p["ln2"], x, cfg), cfg.activation)
    if tp is not None:
        f = tp.ffn_reduce(f)
    return x + f, aux


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


# ---------------------------------------------------------------------------
# forward (inference)
# ---------------------------------------------------------------------------

def layer_views(stacked: PyTree) -> list[PyTree]:
    """Per-layer views of a stacked ``[n, ...]`` tree: writes through a
    view land in the stacked tensors."""
    leaves, td = tree.tree_flatten(stacked)
    per_leaf = [leaf.unbind(0) for leaf in leaves]
    return [tree.tree_unflatten(td, [q[i] for q in per_leaf])
            for i in range(len(per_leaf[0]))]


def rem_first(cfg: ModelConfig) -> bool:
    """A MoE stack runs its remainder (the leading dense layers) before
    the periods; every other family after them."""
    return cfg.family == "moe" and bool(_period_of(cfg)[2])


@torch.no_grad()
def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, *,
            q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, T] -> (hidden [..., B, T, D] after the final norm,
    aux_loss): the reference's forward for the attention stacks, as
    inference (no autograd, no remat).  Under a tensor-parallel hook
    inside a mesh the hidden states carry the rank dims."""
    x = ranked(L.embed_lookup(params["embed"], tokens))
    period, _, _ = _period_of(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    rem = [(params["rem"][name], name.split("_", 1)[1])
           for name in sorted(params["rem"])]
    blocks = [(pp[f"pos{j}_{kind}"], kind)
              for pp in layer_views(params["layers"])
              for j, kind in enumerate(period)]
    order = rem + blocks if rem_first(cfg) else blocks + rem
    for blk, kind in order:
        x, aux = apply_block(blk, x, cfg, kind, q_offset=q_offset)
        aux_total = aux_total + aux
    return _norm(params["final_norm"], x, cfg), aux_total
