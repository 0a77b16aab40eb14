"""Mixture-of-Experts FFN — grouped scatter/gather dispatch.

The port of :mod:`repro.models.moe`: tokens are split into groups;
within a group, routing and capacity bookkeeping are local and tokens are
*scattered* into per-expert capacity slots (O(N·k·D) data movement, not a
one-hot dispatch product).  The group→expert reshard of the slot tensor
is where tensor-parallel serving puts its all-to-all
(:meth:`repro_torch.models.parallel.TensorParallel.moe_dispatch`), and
the way back rides the shared experts' all-reduce (``moe_combine``, the
Type-4 pair :mod:`repro_torch.serve.collectives` compiles into one
``allreduce+alltoall`` stage).

Routing: softmax → top-k → renormalize (Qwen-MoE style), plus the
load-balancing auxiliary loss.  Fixed per-group capacity keeps shapes
static; overflow tokens drop (combine weight 0), as in GShard.
Single-token decode uses capacity = group size (no drops).

The port's own options (:class:`~repro_torch.models.config.MoEConfig`;
each default computes the reference's result):

  * ``norm_topk_prob`` false keeps the top-k softmax scores as they are,
    and ``routed_scaling_factor`` multiplies them (DeepSeek-V2);
  * ``seq_aux``: DeepSeek-V2's sequence-level balance loss, for each
    sequence ``Σ_i f_i P_i`` over every expert (``f_i`` the sequence's
    choices of expert i times ``E / (k T)``, ``P_i`` its mean score),
    the mean over the sequences times ``router_aux_weight``;
  * an expert-parallel share (``n_held``, ``first_held``): the layer
    routes over every expert, holds the stacks of its own, and adds only
    their part of the result (plus the shared experts, whole).  What the
    experts held elsewhere would add is left out: no exchange stands in
    for the chips that hold them;
  * ``dropless`` (:func:`_dropless`): no capacity.  The (token, choice)
    pairs routed to a held expert are sorted by expert, their rows
    gathered, every held expert's FFN run as grouped products over
    per-expert row counts kept on the device (``torch._grouped_mm``),
    the routing weights applied before the last product, and each
    token's rows summed back in f32 through the sort's inverse (a
    gather, no atomics).  No count is read on the host.  The pairs of
    experts held elsewhere sort to the end; they are gathered with the
    rest (the shapes stay static) but neither multiplied nor added.  The
    share is taken only by this path.

While spans are recorded (:func:`repro_torch.obs.spans.span`) the
dropless path runs under ``moe.route`` (router, top-k, sort, gather),
``moe.experts`` (the grouped products and the shared experts) and
``moe.combine`` (the weighted scatter back), and counts
``moe.routed_pairs`` (pairs sent to held experts, a device value read
when the recording closes) and ``moe.dropped_pairs`` (none).

Top-k ties are broken as ``jax.lax.top_k`` breaks them, the lower expert
index first: :func:`top_k` takes the first ``k`` of a *stable*
descending sort (``torch.topk`` promises no order among equal values).

Every function takes leading dims before ``[B, T, D]`` (the rank dim
under tensor parallelism, where the expert stacks are rank-stacked slices
``[tp, E/tp, ...]``).  Under tensor parallelism every rank routes on the
copy of the tokens that the hook's ``moe_route_input`` hands the router
(rank 0's): the ranks' copies of the residual stream may differ by
roundings, and a router near a tie would otherwise send one token to
different experts on different ranks.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import parallel as TP
from repro_torch.models.config import MoEConfig
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import spans as _spans
from repro_torch.sharding.act import shard_act

PyTree = Any

# Target tokens per dispatch group (the reference's GROUP_TOKENS).
GROUP_TOKENS = 4096


def init_moe(gen, d_model: int, cfg: MoEConfig, activation: str,
             dtype=torch.bfloat16, *, device="cpu",
             lead: tuple[int, ...] = ()) -> PyTree:
    """The reference's tree: ``router`` [D, E] f32 (scale 0.02),
    ``experts`` stacks [E_held, d_in, d_out] (every expert unless the
    config holds a share), and ``shared`` (an FFN of ``d_ff_shared or
    n_shared * d_ff_expert``) when ``n_shared``."""
    e, f = cfg.n_experts, cfg.d_ff_expert
    kw = dict(device=device, lead=lead)
    stack = dict(device=device, lead=lead + (cfg.held,))
    p = {"router": L.dense_init(gen, d_model, e, torch.float32, scale=0.02,
                                **kw)}
    if activation in ("swiglu", "geglu"):
        p["experts"] = {"wi_gate": L.dense_init(gen, d_model, f, dtype,
                                                **stack),
                        "wi_up": L.dense_init(gen, d_model, f, dtype, **stack),
                        "wo": L.dense_init(gen, f, d_model, dtype, **stack)}
    else:
        p["experts"] = {"wi": L.dense_init(gen, d_model, f, dtype, **stack),
                        "wo": L.dense_init(gen, f, d_model, dtype, **stack)}
    if cfg.n_shared:
        p["shared"] = L.init_ffn(gen, d_model,
                                 cfg.d_ff_shared or cfg.n_shared * f,
                                 activation, dtype, **kw)
    return p


def _expert_ffn(experts: PyTree, xe: torch.Tensor,
                activation: str) -> torch.Tensor:
    """xe: [..., E, S, D] -> [..., E, S, D] through per-expert FFN
    weights [..., E, d_in, d_out]."""
    def mm(a, w):
        return torch.einsum("...esd,...edf->...esf", a, w)

    if activation in ("swiglu", "geglu"):
        gate = mm(xe, experts["wi_gate"])
        up = mm(xe, experts["wi_up"])
        h = (F.silu(gate) if activation == "swiglu"
             else F.gelu(gate, approximate="tanh")) * up
    else:
        h = mm(xe, experts["wi"])
        h = torch.relu(h).square() if activation == "relu2" else \
            F.gelu(h, approximate="tanh")
    return mm(h, experts["wo"])


def _n_groups(n_tok: int) -> int:
    if n_tok <= GROUP_TOKENS:
        return 1
    g = n_tok // GROUP_TOKENS
    while n_tok % g:
        g -= 1
    return max(g, 1)


def capacity(cfg: MoEConfig, n_tok: int, t: int) -> int:
    """Slots per expert and group: the group size at decode (``t == 1``,
    nothing drops), else ``ng · k · capacity_factor / E`` (at least 1)."""
    ng = n_tok // _n_groups(n_tok)
    if t == 1:
        return ng
    return max(1, int(ng * cfg.top_k * cfg.capacity_factor / cfg.n_experts))


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last dim: the ``k`` largest values in
    descending order, equal values in ascending index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: PyTree, xr: torch.Tensor, cfg: MoEConfig
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router over every expert: ``(probs [..., E], gate_vals,
    gate_idx [..., k])`` of f32 logits ``xr @ router``; the top-k scores
    renormalised where ``norm_topk_prob``, then times
    ``routed_scaling_factor``."""
    logits = L.dense(xr.to(torch.float32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, cfg.top_k)
    if cfg.norm_topk_prob:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(
            1e-9)
    if cfg.routed_scaling_factor != 1.0:
        gate_vals = gate_vals * cfg.routed_scaling_factor
    return probs, gate_vals, gate_idx


def seq_aux_loss(probs: torch.Tensor, gate_idx: torch.Tensor,
                 cfg: MoEConfig) -> torch.Tensor:
    """DeepSeek-V2's sequence-level balance loss of ``probs [..., B, T,
    E]`` and ``gate_idx [..., B, T, k]``: per sequence ``Σ_i f_i P_i``
    with ``f_i`` = choices of expert i × E / (k T) and ``P_i`` the mean
    score, then the mean over B times ``router_aux_weight``; ``[...]``."""
    e, k = cfg.n_experts, cfg.top_k
    t = probs.shape[-2]
    choices = F.one_hot(gate_idx, e).to(torch.float32).sum((-3, -2))
    f = choices * (e / (k * t))                               # [..., B, E]
    return (f * probs.mean(-2)).sum(-1).mean(-1) * cfg.router_aux_weight


def balance_loss(probs: torch.Tensor, gate_idx: torch.Tensor,
                 cfg: MoEConfig, tp=None) -> torch.Tensor:
    """The router's auxiliary loss over ``probs [..., B, T, E]`` and
    ``gate_idx [..., B, T, k]``: :func:`seq_aux_loss` where ``seq_aux``,
    else the reference's load-balance loss over every token, ``E Σ_e f_e
    p_e`` (``f_e`` the share of first choices, ``p_e`` the mean score;
    under tensor parallelism the hook's means)."""
    if cfg.seq_aux:
        return seq_aux_loss(probs, gate_idx, cfg)
    e = cfg.n_experts
    me = probs.mean(dim=(-3, -2))
    ce = F.one_hot(gate_idx[..., 0], e).to(torch.float32).mean(dim=(-3, -2))
    if tp is not None:
        me, ce = tp.moe_aux_means(me, ce)
    return e * (me * ce).sum(-1) * cfg.router_aux_weight


def moe_ffn(p: PyTree, x: torch.Tensor, cfg: MoEConfig, activation: str
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [..., B, T, D].  Returns (y in x's dtype, aux_loss)."""
    if cfg.dropless:
        return _dropless(p, x, cfg, activation)
    if cfg.held != cfg.n_experts:
        raise ValueError("a share of the experts is taken only by the "
                         "dropless path (dropless=True)")
    lead = tuple(x.shape[:-3])
    b, t, d = x.shape[-3:]
    n_tok = b * t
    e, k = cfg.n_experts, cfg.top_k
    g = _n_groups(n_tok)
    ng = n_tok // g
    cap = capacity(cfg, n_tok, t)
    xt = x.reshape(lead + (g, ng, d))
    tp = TP.current()

    # under tensor parallelism the router reads one rank's copy (the
    # hook's moe_route_input), and its lead dims broadcast over the ranks
    xr = xt if tp is None else tp.moe_route_input(xt)
    rlead = tuple(xr.shape[:-3])
    probs, gate_vals, gate_idx = route(p, xr, cfg)   # [.., G, Ng, E or k]

    # position-in-expert within the group, k-major priority (GShard order)
    onehot = F.one_hot(gate_idx, e).to(torch.float32)          # [.., G,Ng,k,E]
    flat = onehot.transpose(-3, -2).reshape(rlead + (g, k * ng, e))
    pos_flat = torch.cumsum(flat, dim=-2) - flat
    pos = pos_flat.reshape(rlead + (g, k, ng, e)).transpose(-3, -2)
    pos_in_e = (pos * onehot).sum(-1).to(torch.int64)          # [.., G, Ng, k]
    keep = pos_in_e < cap

    # scatter tokens into capacity slots [.., G, E*cap (+ a dump slot), D]
    # in the activation dtype: each real slot receives at most one token
    n_slots = e * cap
    slot = torch.where(keep, gate_idx * cap + pos_in_e,
                       torch.full_like(pos_in_e, n_slots))
    xe = torch.zeros(lead + (g, n_slots + 1, d), dtype=x.dtype,
                     device=x.device)
    for j in range(k):                  # k small: one scatter per choice
        xe.scatter_add_(-2, slot[..., j, None].expand(xt.shape), xt)
    xe = shard_act(xe[..., :n_slots, :].reshape(lead + (g, e, cap, d)),
                   "dp", None, None, None)

    # group-major -> expert-major: THE all-to-all under tensor parallelism
    xem = xe.transpose(-4, -3).reshape(lead + (e, g * cap, d))
    xem = shard_act(xem, "tp", "dp", None)
    if tp is not None:                  # rank-local TP (serving path)
        xem = tp.moe_dispatch(xem)      # [E, S, D] -> [E/tp, S, D]
    yem = shard_act(_expert_ffn(p["experts"], xem, activation),
                    "tp", "dp", None)
    shared_y = None
    if tp is not None:
        # the shared-expert partial rides the combine all-to-all
        part = L.ffn(p["shared"], xt, activation) if "shared" in p else None
        yem, shared_y = tp.moe_combine(yem, part)
    elif "shared" in p:
        shared_y = L.ffn(p["shared"], xt, activation)
    ylead = tuple(yem.shape[:-3])
    ye = yem.reshape(ylead + (e, g, cap, d)).transpose(-4, -3) \
        .reshape(ylead + (g, n_slots, d))
    ye = torch.cat([ye, ye.new_zeros(ylead + (g, 1, d))], dim=-2)

    y = torch.zeros(torch.broadcast_shapes(ylead, lead) + (g, ng, d),
                    dtype=torch.float32, device=x.device)
    for j in range(k):                  # gather + weighted combine
        yj = torch.take_along_dim(ye, slot[..., j, None], dim=-2)
        wj = gate_vals[..., j] * keep[..., j].to(torch.float32)
        y = y + yj.to(torch.float32) * wj[..., None]
    if shared_y is not None:
        y = y + shared_y.to(torch.float32)
    rec = _metrics.RECORDER
    if rec.spans is not None:
        rec.count("moe.dropped_pairs", (~keep).sum())
    sh = rlead + (b, t)
    aux = balance_loss(probs.reshape(sh + (e,)), gate_idx.reshape(sh + (k,)),
                       cfg, tp)
    return y.reshape(y.shape[:-3] + (b, t, d)).to(x.dtype), aux


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               ends: torch.Tensor) -> torch.Tensor:
    """Rows ``ends[g-1] .. ends[g] - 1`` of ``x [M, K]`` times ``w[g]
    [K, N]`` for every group g (``ends`` int32 on x's device, the groups'
    row ends in order); rows past ``ends[-1]`` are not computed and hold
    no defined value.  On the card ``torch._grouped_mm``, which reads the
    ends on the device; on the CPU a product a group (zeros past the
    end)."""
    if x.is_cuda:
        return torch._grouped_mm(x, w, ends)
    bounds = [0] + ends.tolist()
    parts = [x[a:b] @ w[g] for g, (a, b) in enumerate(zip(bounds,
                                                         bounds[1:]))]
    parts.append(x.new_zeros((x.shape[0] - bounds[-1], w.shape[-1])))
    return torch.cat(parts)


def _dropless(p: PyTree, x: torch.Tensor, cfg: MoEConfig, activation: str
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_ffn` without capacity, over the held share: x [*lead, B,
    T, D] (lead the rank dims, the experts' stacks ``[*lead, E_held,
    ...]`` or ``[E_held, ...]``).  Groups are (rank, held expert) pairs,
    so each rank's gradient of an expert stays its own."""
    if TP.current() is not None or activation not in ("swiglu", "geglu"):
        raise ValueError("the dropless path takes a gated FFN without "
                         "tensor parallelism")
    lead = tuple(x.shape[:-3])
    b, t, d = x.shape[-3:]
    k, eh = cfg.top_k, cfg.held
    r = math.prod(lead)
    n = r * b * t                         # tokens over every rank
    groups = r * eh
    dev = x.device
    with _spans.span("moe.route"):
        probs, gate_vals, gate_idx = route(p, x, cfg)     # [*lead, B, T, ·]
        local = gate_idx.reshape(r, -1) - cfg.first_held  # [r, B·T·k]
        held = (local >= 0) & (local < eh)
        rank = torch.arange(r, device=dev)[:, None] * eh
        key = torch.where(held, local + rank, groups).reshape(-1)
        key, order = torch.sort(key, stable=True)
        ends = torch.searchsorted(
            key, torch.arange(1, groups + 1, device=dev)).to(torch.int32)
        sent = (key < groups)[:, None]
        # a pair sent elsewhere reads its token too; the masks keep its
        # row (not computed past ends[-1]) out of every result and gradient
        xs = torch.where(sent, x.reshape(n, d).index_select(0, order // k),
                         0.0)
        wts = torch.where(sent, gate_vals.reshape(-1).index_select(
            0, order)[:, None], 0.0)

    def stack(w):               # [*lead, E_held, d_in, d_out] -> [groups, ...]
        return w.expand(lead + w.shape[-3:]).reshape((groups,)
                                                     + w.shape[-2:])

    with _spans.span("moe.experts"):
        ex = p["experts"]
        gate = grouped_mm(xs, stack(ex["wi_gate"]), ends)
        up = grouped_mm(xs, stack(ex["wi_up"]), ends)
        h = (F.silu(gate) if activation == "swiglu"
             else F.gelu(gate, approximate="tanh")) * up
        ys = grouped_mm(h * wts.to(h.dtype), stack(ex["wo"]), ends)
        shared_y = L.ffn(p["shared"], x, activation) if "shared" in p \
            else None
    with _spans.span("moe.combine"):
        # back to (token, choice) order by the inverse of the sort, then
        # each token's weighted rows summed in f32
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=dev))
        yk = torch.where(held.reshape(-1, 1), ys.index_select(0, inv), 0.0)
        y = yk.reshape(x.shape[:-1] + (k, d)).sum(-2, dtype=torch.float32)
        if shared_y is not None:
            y = y + shared_y.to(torch.float32)
    rec = _metrics.RECORDER
    if rec.spans is not None:
        rec.count("moe.routed_pairs", ends[-1])
        rec.count("moe.dropped_pairs", 0)
    return y.to(x.dtype), balance_loss(probs, gate_idx, cfg)
