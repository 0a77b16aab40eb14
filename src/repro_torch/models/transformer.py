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

:func:`apply_block` and :func:`forward` are the reference's training
forward (and the inference one, when nothing requires grad) for every
ported kind; they consult the tensor-parallel hook
(:mod:`repro_torch.models.parallel`) where the reference does.
``cfg.remat`` is the reference's ``_remat`` policy per period: ``"full"``
checkpoints each period, ``"dots"`` saves its matmul outputs and
recomputes the rest.
Tokens may carry rank dims in front (``[*rank, B, T]``) with every param
rank-stacked: the train step's per-rank gradients come from one forward
and one backward that way.  MLA attention (deepseek-v2) and the
``encdec`` and ``vlm`` kinds wait for ROADMAP.md queue 1 item 6.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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
    """One block over x [..., B, T, D] from position ``q_offset``: RWKV-6
    token and channel mix (``rwkv``), the RG-LRU block and its FFN
    (``lru``), or attention (causal GQA; ``window`` with the local
    window) then the dense FFN or the MoE FFN.  Returns (x, aux_loss);
    the aux loss is the MoE's, one per rank under rank dims."""
    _check_kind(cfg, kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "rwkv":
        x = x + RW.rwkv6_token_mix(p["tok"], _norm(p["ln1"], x, cfg),
                                   chunk=cfg.wkv_chunk)
        return x + RW.rwkv6_channel_mix(p["ch"], _norm(p["ln2"], x, cfg)), aux
    if kind == "lru":
        x = x + RG.rglru_block(p["mixer"], _norm(p["ln1"], x, cfg),
                               cfg=cfg.hybrid)
        return x + L.ffn(p["ffn"], _norm(p["ln2"], x, cfg),
                         cfg.activation), aux
    tp = TP.current()
    h = A.gqa_attention(p["attn"], _norm(p["ln1"], x, cfg), causal=True,
                        window=cfg.hybrid.window if kind == "window" else None,
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
    w = params["embed"].transpose(-1, -2) if cfg.tie_embeddings \
        else params["lm_head"]
    return L.logits_head(hidden, w)


# ---------------------------------------------------------------------------
# forward (training / inference)
# ---------------------------------------------------------------------------

def layer_views(stacked: PyTree, dim: int = 0) -> list[PyTree]:
    """Per-layer views of a stacked tree (the layer dim at ``dim``, after
    any rank dims): writes through a view land in the stacked tensors,
    and under autograd the layers' gradients stack back in one
    ``unbind`` backward."""
    leaves, td = tree.tree_flatten(stacked)
    per_leaf = [leaf.unbind(dim) for leaf in leaves]
    return [tree.tree_unflatten(td, [q[i] for q in per_leaf])
            for i in range(len(per_leaf[0]))]


def rem_first(cfg: ModelConfig) -> bool:
    """A MoE stack runs its remainder (the leading dense layers) before
    the periods; every other family after them."""
    return cfg.family == "moe" and bool(_period_of(cfg)[2])


# the matmul outputs the "dots" policy keeps (the reference saves its
# dots; every dense product here is one of these ops)
_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default))


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """The reference's ``_remat``: ``none`` as it is, ``full`` recomputes
    the whole period in the backward, ``dots`` keeps matmul outputs."""
    if policy == "none":
        return fn
    if policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=ctx)
    if policy != "full":
        raise ValueError(f"unknown remat policy {policy!r}")
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, *,
            q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [*rank, B, T] -> (hidden [*rank, B, T, D] after the final
    norm, aux_loss [*rank]): the reference's ``forward``/``_scan_stack``
    (a MoE stack's remainder first, every other's last; the periods'
    aux losses summed as one stack, as its scan sums them).  With rank
    dims every param carries them too (``[*rank, ...]``, the stacked
    layers ``[*rank, n_periods, ...]``).  Under a tensor-parallel hook
    inside a mesh (serving) the hidden states carry the rank dims."""
    nd = tokens.dim() - 2
    x = ranked(L.embed_lookup(params["embed"], tokens))
    period, _, _ = _period_of(cfg)

    def period_body(x, pp):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, kind in enumerate(period):
            x, a = apply_block(pp[f"pos{j}_{kind}"], x, cfg, kind,
                               q_offset=q_offset)
            aux = aux + a
        return x, aux

    def run_rem(x, aux_total):
        for name in sorted(params["rem"]):
            x, a = apply_block(params["rem"][name], x, cfg,
                               name.split("_", 1)[1], q_offset=q_offset)
            aux_total = aux_total + a
        return x, aux_total

    body = _remat(period_body, cfg.remat)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if rem_first(cfg):
        x, aux_total = run_rem(x, aux_total)
    auxs = []
    for pp in layer_views(params["layers"], dim=nd):
        x, a = body(x, pp)
        auxs.append(a)
    if auxs and cfg.scan_layers:
        aux_total = aux_total + torch.stack(
            torch.broadcast_tensors(*auxs)).sum(0)
    else:
        for a in auxs:
            aux_total = aux_total + a
    if not rem_first(cfg):
        x, aux_total = run_rem(x, aux_total)
    return _norm(params["final_norm"], x, cfg), aux_total
