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

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import parallel as TP
from repro_torch.models.config import MoEConfig
from repro_torch.sharding.act import shard_act

PyTree = Any

# Target tokens per dispatch group (the reference's GROUP_TOKENS).
GROUP_TOKENS = 4096


def init_moe(gen, d_model: int, cfg: MoEConfig, activation: str,
             dtype=torch.bfloat16, *, device="cpu",
             lead: tuple[int, ...] = ()) -> PyTree:
    """The reference's tree: ``router`` [D, E] f32 (scale 0.02),
    ``experts`` stacks [E, d_in, d_out], and ``shared`` (an FFN of
    ``d_ff_shared or n_shared * d_ff_expert``) when ``n_shared``."""
    e, f = cfg.n_experts, cfg.d_ff_expert
    kw = dict(device=device, lead=lead)
    stack = dict(device=device, lead=lead + (e,))
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


def moe_ffn(p: PyTree, x: torch.Tensor, cfg: MoEConfig, activation: str
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [..., B, T, D].  Returns (y in x's dtype, aux_loss)."""
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
    logits = L.dense(xr.to(torch.float32), p["router"])      # [.., G, Ng, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)                      # [.., G, Ng, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

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

    # load-balance aux: E * sum_e f_e * p_e
    me = probs.mean(dim=(-3, -2))
    ce = onehot[..., 0, :].mean(dim=(-3, -2))
    if tp is not None:
        me, ce = tp.moe_aux_means(me, ce)
    aux = e * (me * ce).sum(-1) * cfg.router_aux_weight
    return y.reshape(y.shape[:-3] + (b, t, d)).to(x.dtype), aux
