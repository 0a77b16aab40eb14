"""Model assembly: blocks per family, the stacked layer layout, logits,
the encoder, and the forward of every family.

The port of :mod:`repro.models.transformer`.  Params keep the
reference's tree: ``embed``, ``final_norm``, ``lm_head`` (untied),
``layers`` — one entry per position of the repeating period, each leaf
stacked ``[n_periods, ...]`` — and ``rem``, the unstacked remainder (a
MoE stack's leading dense layers, run *before* the periods); an encdec
stack adds ``enc`` (``pos [encoder_seq, D]``, the stacked
``layers.pos0_enc_self``, ``final_norm``) and ``dec_pos [max_seq, D]``.
Init takes an explicit ``torch.Generator`` and a device; the stacked
leaves are drawn in one go (``lead=(n,)``), with the reference's
distributions and dtypes leaf by leaf.

Families: dense ``[self] × L``; moe ``[dense_self] × lead + [moe_self]``
(GQA or MLA attention); hybrid (``lru``, ``window``); ssm (``rwkv``);
encdec, an encoder ``[enc_self] × Le`` (non-causal) and a decoder
``[dec_self_cross] × L`` (no RoPE on either); vlm, periods of ``[cross,
self × (k-1)]`` whose ``cross`` layers add ``tanh(gate)``-gated cross
attention and FFN over the image embeddings.

:func:`apply_block` and :func:`forward` are the reference's training
forward (and the inference one, when nothing requires grad) for every
kind; they consult the tensor-parallel hook
(:mod:`repro_torch.models.parallel`) where the reference does.
``cfg.remat`` is the reference's ``_remat`` policy per period: ``"full"``
checkpoints each period, ``"dots"`` saves its matmul outputs and
recomputes the rest.  Tokens and context may carry rank dims in front
(``[*rank, B, T]``) with every param rank-stacked: the train step's
per-rank gradients come from one forward and one backward that way.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tree
from repro_torch.mesh import ambient
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import parallel as TP
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.act import shard_act

PyTree = Any


ATTENTION_KINDS = ("self", "dense_self", "moe_self")


# ---------------------------------------------------------------------------
# block init (one layer, or n stacked with lead=(n,))
# ---------------------------------------------------------------------------

def _init_attn(gen, cfg: ModelConfig, dt, qk_norm: bool, **kw) -> PyTree:
    return A.init_gqa(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim, qk_norm, dt, **kw)


def init_block(gen, cfg: ModelConfig, kind: str, *, device="cpu",
               lead: tuple[int, ...] = ()) -> PyTree:
    """kind ∈ {self, window, enc_self, cross, lru, moe_self, dense_self,
    rwkv, dec_self_cross}; ``dense_self`` and ``moe_self`` attend by MLA
    when the config has one.  A ``cross`` block's two gates are 0-dim f32
    zeros (``[*lead]`` stacked), as the reference's."""
    dt = L._dtype(cfg.param_dtype)
    d = cfg.d_model
    norm = dict(device=device, lead=lead)
    p = {"ln1": L.init_norm(d, cfg.norm, **norm),
         "ln2": L.init_norm(d, cfg.norm, **norm)}
    if kind == "rwkv":
        p["tok"] = RW.init_rwkv6(gen, d, dt, **norm)
        p["ch"] = RW.init_channel_mix(gen, d, cfg.d_ff, dt, **norm)
        return p
    if kind == "lru":
        p["mixer"] = RG.init_rglru(gen, d, cfg.hybrid, dt, **norm)
    elif kind in ("dense_self", "moe_self") and cfg.mla is not None:
        p["attn"] = MLA.init_mla(gen, d, cfg.n_heads, cfg.mla, dt, **norm)
    elif kind in ("self", "window", "enc_self", "cross", "dense_self",
                  "moe_self", "dec_self_cross"):
        p["attn"] = _init_attn(gen, cfg, dt, cfg.qk_norm, **norm)
    else:
        raise ValueError(f"unknown block kind {kind}")
    if kind == "dec_self_cross":
        p["ln_x"] = L.init_norm(d, cfg.norm, **norm)
        p["xattn"] = _init_attn(gen, cfg, dt, False, **norm)
    if kind == "moe_self":
        p["moe"] = MOE.init_moe(gen, d, cfg.moe, cfg.activation, dt, **norm)
    else:
        d_ff = cfg.moe.d_ff_dense or cfg.d_ff if kind == "dense_self" \
            else cfg.d_ff
        p["ffn"] = L.init_ffn(gen, d, d_ff, cfg.activation, dt, **norm)
    if kind == "cross":
        p["gate_attn"] = torch.zeros(lead, dtype=torch.float32,
                                     device=device)
        p["gate_ffn"] = torch.zeros(lead, dtype=torch.float32, device=device)
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


def _gated(gate: torch.Tensor, h: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """``tanh(gate)·h``, the f32 gate's tanh (0-dim, or ``[*rank]`` under
    rank dims) rounded to the stream's ``dtype`` first, as the
    reference's ``tanh(gate).astype(x.dtype) * h``."""
    return L.lift(torch.tanh(gate).to(dtype), h, own=0) * h


def apply_block(p: PyTree, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                context=None, q_offset: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One block (:func:`_block`), its output pinned batch-sharded
    (``shard_act``) as the reference pins it."""
    x, aux = _block(p, x, cfg, kind, context=context, q_offset=q_offset)
    return shard_act(x, "dp", None, None), aux


def _block(p: PyTree, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
           context=None, q_offset: int = 0
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One block over x [..., B, T, D] from position ``q_offset``: RWKV-6
    token and channel mix (``rwkv``), the RG-LRU block and its FFN
    (``lru``), attention then the dense FFN or the MoE FFN (``self``,
    ``window``, ``dense_self``, ``moe_self``; MLA where the config has
    it; ``enc_self`` without the causal mask), the gated cross-attention
    layer over ``context`` (``cross``), or the decoder's causal self
    attention, cross attention over ``context`` and FFN
    (``dec_self_cross``, no RoPE).  The encdec family uses no RoPE.
    Returns (x, aux_loss); the aux loss is the MoE's, one per rank under
    rank dims."""
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
    akw = dict(_attn_kw(cfg), chunk=cfg.attn_chunk, q_offset=q_offset)
    if kind == "cross":
        h = A.gqa_attention(p["attn"], _norm(p["ln1"], x, cfg),
                            context=context, causal=False, **akw)
        x = x + _gated(p["gate_attn"], h, x.dtype)
        f = L.ffn(p["ffn"], _norm(p["ln2"], x, cfg), cfg.activation)
        return x + _gated(p["gate_ffn"], f, x.dtype), aux
    if kind == "dec_self_cross":
        x = x + A.gqa_attention(p["attn"], _norm(p["ln1"], x, cfg),
                                causal=True, use_rope=False, **akw)
        x = x + A.gqa_attention(p["xattn"], _norm(p["ln_x"], x, cfg),
                                context=context, causal=False,
                                use_rope=False, **akw)
        return x + L.ffn(p["ffn"], _norm(p["ln2"], x, cfg),
                         cfg.activation), aux
    if kind not in ATTENTION_KINDS + ("window", "enc_self"):
        raise ValueError(kind)
    tp = TP.current()
    if cfg.mla is not None and kind in ("dense_self", "moe_self"):
        h = MLA.mla_attention(p["attn"], _norm(p["ln1"], x, cfg),
                              n_heads=cfg.n_heads, cfg=cfg.mla,
                              rope_theta=cfg.rope_theta, q_offset=q_offset,
                              chunk=cfg.attn_chunk)
    else:
        h = A.gqa_attention(
            p["attn"], _norm(p["ln1"], x, cfg), causal=kind != "enc_self",
            window=cfg.hybrid.window if kind == "window" else None,
            use_rope=cfg.family != "encdec", **akw)
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
        e = cfg.encdec
        p["enc"] = {
            "pos": (0.02 * L.normal(gen, (e.encoder_seq, cfg.d_model),
                                    device)).to(dt),
            "layers": {"pos0_enc_self": init_block(
                gen, cfg, "enc_self", device=device,
                lead=(e.n_encoder_layers,))},
            "final_norm": L.init_norm(cfg.d_model, cfg.norm, device=device),
        }
        p["dec_pos"] = (0.02 * L.normal(gen, (cfg.max_seq, cfg.d_model),
                                        device)).to(dt)
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


@contextlib.contextmanager
def _entered(*cms):
    with contextlib.ExitStack() as stack:
        for cm in cms:
            stack.enter_context(cm)
        yield


def _remat(fn, policy: str):
    """The reference's ``_remat``: ``none`` as it is, ``full`` recomputes
    the whole period in the backward, ``dots`` keeps matmul outputs.
    The recompute runs under the tensor-parallel hook active now: the
    backward runs outside the forward's ``with tensor_parallel(...)``,
    and without the hook a split period would recompute partial sums."""
    if policy == "none":
        return fn
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")
    hook = TP.current()

    def contexts():
        fwd, rec = create_selective_checkpoint_contexts(_save_dots) \
            if policy == "dots" else (contextlib.nullcontext(),
                                      contextlib.nullcontext())
        if hook is not None:
            rec = _entered(rec, TP.tensor_parallel(hook))
        return fwd, rec

    return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                 context_fn=contexts)


def _scan_stack(p_layers: PyTree, x: torch.Tensor, cfg: ModelConfig,
                period: list[str], *, nd: int, where: tuple = ("layers",),
                context=None, q_offset: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_scan_stack``: the stacked periods (the layer dim
    after ``nd`` rank dims) in depth order, each period under the
    config's remat policy; the periods' aux losses summed as one stack,
    as its scan sums them.  An active tensor-parallel hook sees each
    period's params first (``layer_params``, ``where`` the stack's
    path), inside the remat region: a recomputed period gathers its
    params again, so none is kept for the backward."""
    hook = TP.current()

    def period_body(x, pp):
        if hook is not None:
            pp = hook.layer_params(pp, where)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, kind in enumerate(period):
            x, a = apply_block(pp[f"pos{j}_{kind}"], x, cfg, kind,
                               context=context, q_offset=q_offset)
            aux = aux + a
        return x, aux

    body = _remat(period_body, cfg.remat)
    auxs = []
    for pp in layer_views(p_layers, dim=nd):
        x, a = body(x, pp)
        auxs.append(a)
    if auxs and cfg.scan_layers:
        return x, torch.stack(torch.broadcast_tensors(*auxs)).sum(0)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in auxs:
        aux_total = aux_total + a
    return x, aux_total


def encode(params: PyTree, cfg: ModelConfig,
           enc_embeds: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over stub frame embeddings [*rank, B, Te, D]:
    the learned positions in the embeddings' dtype, the non-causal
    ``enc_self`` stack without RoPE, the encoder's final norm."""
    e = params["enc"]
    nd = enc_embeds.dim() - 3
    te = enc_embeds.shape[-2]
    x = enc_embeds + L.lift(e["pos"][..., :te, :], enc_embeds, own=2).to(
        enc_embeds.dtype)
    x, _ = _scan_stack(e["layers"], x, cfg, ["enc_self"], nd=nd,
                       where=("enc", "layers"))
    return _norm(e["final_norm"], x, cfg)


def forward(params: PyTree, cfg: ModelConfig, tokens: torch.Tensor, *,
            context=None, q_offset: int = 0
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [*rank, B, T] -> (hidden [*rank, B, T, D] after the final
    norm, aux_loss [*rank]): the reference's ``forward``/``_scan_stack``
    (a MoE stack's remainder first, every other's last).  ``context``
    [*rank, B, Tc, D] is the encoder memory (encdec, after
    :func:`encode`) or the image embeddings (vlm) the cross attentions
    read; an encdec stack adds its learned decoder positions from
    ``q_offset``.  With rank dims every param carries them too
    (``[*rank, ...]``, the stacked layers ``[*rank, n_periods, ...]``).
    Under a tensor-parallel hook inside a mesh (serving) the hidden
    states carry the rank dims."""
    nd = tokens.dim() - 2
    x = ranked(L.embed_lookup(params["embed"], tokens))
    if cfg.family == "encdec":
        pos = params["dec_pos"][..., q_offset:q_offset + tokens.shape[-1], :]
        x = x + L.lift(pos, x, own=2).to(x.dtype)
    period, _, _ = _period_of(cfg)

    def run_rem(x, aux_total):
        for name in sorted(params["rem"]):
            x, a = apply_block(params["rem"][name], x, cfg,
                               name.split("_", 1)[1], context=context,
                               q_offset=q_offset)
            aux_total = aux_total + a
        return x, aux_total

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if rem_first(cfg):
        x, aux_total = run_rem(x, aux_total)
    x, aux = _scan_stack(params["layers"], x, cfg, period, nd=nd,
                         context=context, q_offset=q_offset)
    aux_total = aux_total + aux
    if not rem_first(cfg):
        x, aux_total = run_rem(x, aux_total)
    return _norm(params["final_norm"], x, cfg), aux_total
