"""The plain reference of the ``moe`` family with latent attention
(DeepSeek-V2-Lite): parameter layout, forward, loss and the first
training steps, in float32, from the configuration's JSON alone.

Written from DeepSeek-V2's equations (arXiv:2405.04434, and the
published modelling code ``modeling_deepseek.py``: ``DeepseekV2Attention``
with ``DeepseekV2YarnRotaryEmbedding``, ``MoEGate``, ``DeepseekV2MoE``).
No kernel, cache or fused op, no import of the port: every product is
``mm`` (float32 without TF32, or the control's float8,
:func:`portbench.reference.model.matmul`), attention a full softmax over
explicit per-head scores.

  * attention (MLA, no query compression): ``q = W_q h`` split into a
    128-wide part and a 64-wide rope part a head; ``[c ; k_r] = W_dkv h``,
    ``c`` RMS-normed (eps 1e-6); per head the key ``[W_uk c ; k_r]`` (the
    one rope key shared by every head) and the value ``W_uv c``; the rope
    parts rotate by YaRN's frequencies; softmax scale
    ``192^-1/2 · m²``, ``m = 0.1 · mscale_all_dim · ln(factor) + 1``;
    causal; then ``W_o``;
  * the first layer's FFN is dense (SwiGLU); every later layer's is the
    MoE: a float32 router over all ``router_experts`` experts, softmax
    scores, the top ``k`` kept as they are (``norm_topk_prob`` false)
    times ``routed_scaling_factor``; each held expert's SwiGLU over the
    tokens routed to it, weighted; the shared experts (one SwiGLU of
    ``n_shared`` × the expert width) over every token;
  * the balance loss (``seq_aux``): per sequence and layer ``α Σ_i f_i
    P_i`` over every expert, ``f_i`` = the sequence's choices of expert i
    × E / (k T), ``P_i`` its mean score;
  * loss: next-token cross entropy plus ``z_loss · logsumexp²`` a token,
    the mean over a row's targets, plus the row's balance loss;
  * training: each data rank's gradient of its rows' mean loss, the mean
    over the ranks (the ``acis`` sync's result), AdamW.

Departures from the published model, each a cut or an assumption the
configuration file states: only the experts held here (``n_routed_experts``
of the ``router_experts`` the router scores) add to a layer's output, the
rest are left out as the deployment's other chips would add them; the
vocabulary is a slice (``vocab``); no token is dropped (DeepSeek-V2's
training dropped tokens at device level); the rope dims are in the
half-split layout, not HF's interleave (a fixed permutation of random
weights); the z-loss is the port's train step's, not DeepSeek-V2's.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from portbench.reference.model import float32_matmuls, matmul, rmsnorm
from portbench.reference.spec import DTYPES, Leaf

ROUTER_STD = 0.02


# -- the parameter layout -----------------------------------------------------

def _dense(path: str, d_in: int, d_out: int, dt, lead: tuple) -> Leaf:
    return Leaf(path, lead + (d_in, d_out), dt,
                ("normal", 1.0 / math.sqrt(d_in)))


def _swiglu(prefix: str, d: int, f: int, dt, lead: tuple) -> list[Leaf]:
    return [_dense(prefix + ".wi_gate", d, f, dt, lead),
            _dense(prefix + ".wi_up", d, f, dt, lead),
            _dense(prefix + ".wo", f, d, dt, lead)]


def _mla(prefix: str, cfg: dict, dt, lead: tuple) -> list[Leaf]:
    d, h, m = cfg["d_model"], cfg["n_heads"], cfg["mla"]
    qk = m["nope_head_dim"] + m["rope_head_dim"]
    return [_dense(prefix + ".wq", d, h * qk, dt, lead),
            _dense(prefix + ".w_dkv", d, m["kv_lora"] + m["rope_head_dim"],
                   dt, lead),
            Leaf(prefix + ".kv_norm.scale", lead + (m["kv_lora"],),
                 torch.float32, ("ones",)),
            _dense(prefix + ".w_uk", m["kv_lora"], h * m["nope_head_dim"], dt,
                   lead),
            _dense(prefix + ".w_uv", m["kv_lora"], h * m["v_head_dim"], dt,
                   lead),
            _dense(prefix + ".wo", h * m["v_head_dim"], d, dt, lead)]


def _norms(prefix: str, d: int, lead: tuple) -> list[Leaf]:
    return [Leaf(f"{prefix}.{n}.scale", lead + (d,), torch.float32, ("ones",))
            for n in ("ln1", "ln2")]


DENSE = "rem.rem0_dense_self"
MOE = "layers.pos0_moe_self"


def param_spec(cfg: dict) -> list[Leaf]:
    """Every parameter leaf, sorted by path, in the port's tree: the
    dense first layer unstacked (``rem``), the MoE layers stacked
    (``layers``, the layer count first)."""
    dt = DTYPES[cfg["param_dtype"]]
    d, v, m = cfg["d_model"], cfg["vocab"], cfg["moe"]
    n = cfg["n_layers"] - 1
    leaves = [Leaf("embed", (v, d), dt, ("normal", 1.0)),
              _dense("lm_head", d, v, dt, ()),
              Leaf("final_norm.scale", (d,), torch.float32, ("ones",))]
    leaves += _norms(DENSE, d, ()) + _mla(DENSE + ".attn", cfg, dt, ())
    leaves += _swiglu(DENSE + ".ffn", d, cfg["d_ff"], dt, ())
    lead = (n,)
    leaves += _norms(MOE, d, lead) + _mla(MOE + ".attn", cfg, dt, lead)
    leaves.append(Leaf(MOE + ".moe.router", lead + (d, m["n_experts"]),
                       torch.float32, ("normal", ROUTER_STD)))
    held = lead + (m["n_held"],)
    leaves += _swiglu(MOE + ".moe.experts", d, m["d_ff_expert"], dt, held)
    leaves += _swiglu(MOE + ".moe.shared", d, m["d_ff_shared"], dt, lead)
    return sorted(leaves, key=lambda x: x.path)


def param_count(cfg: dict) -> int:
    return sum(math.prod(x.shape) for x in param_spec(cfg))


# -- the forward --------------------------------------------------------------

def _yarn_m(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def rope_frequencies(cfg: dict, device) -> torch.Tensor:
    """YaRN's inverse frequencies of the rope dims (as
    ``DeepseekV2YarnRotaryEmbedding``), or RoPE's without ``yarn``."""
    m = cfg["mla"]
    d, base = m["rope_head_dim"], cfg["rope_theta"]
    extra = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=device) / d)
    y = m.get("yarn")
    if not y:
        return extra

    def dim_of(rot):
        return d * math.log(y["original_max"] / (rot * 2 * math.pi)) \
            / (2 * math.log(base))
    low = max(math.floor(dim_of(y["beta_fast"])), 0)
    high = min(math.ceil(dim_of(y["beta_slow"])), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return extra / y["factor"] * (1 - keep) + extra * keep


def softmax_scale(cfg: dict) -> float:
    m = cfg["mla"]
    scale = (m["nope_head_dim"] + m["rope_head_dim"]) ** -0.5
    y = m.get("yarn")
    if y and y.get("mscale_all_dim"):
        scale *= _yarn_m(y["factor"], y["mscale_all_dim"]) ** 2
    return scale


def rope(x: torch.Tensor, freqs: torch.Tensor, mscale: float = 1.0):
    """x [b, T, H, d] at positions 0..T-1, the half-split layout."""
    t = x.shape[1]
    ang = torch.arange(t, dtype=torch.float32,
                       device=x.device)[:, None, None] * freqs
    cos, sin = torch.cos(ang) * mscale, torch.sin(ang) * mscale
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mla(W, prefix, pick, x, cfg, mm) -> torch.Tensor:
    m = cfg["mla"]
    h, nope, r, vd = (cfg["n_heads"], m["nope_head_dim"], m["rope_head_dim"],
                      m["v_head_dim"])
    b, t, _ = x.shape
    y = m.get("yarn")
    ms = _yarn_m(y["factor"], y["mscale"]) / _yarn_m(
        y["factor"], y["mscale_all_dim"]) if y else 1.0
    freqs = rope_frequencies(cfg, x.device)
    q = mm(x, pick(W[prefix + ".wq"])).reshape(b, t, h, nope + r)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], freqs, ms)], -1)
    dkv = mm(x, pick(W[prefix + ".w_dkv"]))
    c = rmsnorm(dkv[..., :m["kv_lora"]], pick(W[prefix + ".kv_norm.scale"]),
                1e-6)
    k_r = rope(dkv[..., m["kv_lora"]:][:, :, None, :], freqs, ms)
    k = torch.cat([mm(c, pick(W[prefix + ".w_uk"])).reshape(b, t, h, nope),
                   k_r.expand(b, t, h, r)], -1)
    v = mm(c, pick(W[prefix + ".w_uv"])).reshape(b, t, h, vd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * softmax_scale(cfg)
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    s = s.masked_fill(mask, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return mm(o.reshape(b, t, h * vd), pick(W[prefix + ".wo"]))


def swiglu(W, prefix, pick, x, mm) -> torch.Tensor:
    return mm(F.silu(mm(x, pick(W[prefix + ".wi_gate"])))
              * mm(x, pick(W[prefix + ".wi_up"])), pick(W[prefix + ".wo"]))


def moe(W, prefix, pick, x, cfg, mm) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN over x [b, T, d]: (the held experts' part plus the
    shared experts', each row's balance loss [b])."""
    m = cfg["moe"]
    e, k = m["n_experts"], m["top_k"]
    b, t, d = x.shape
    probs = torch.softmax(mm(x, pick(W[prefix + ".router"])), dim=-1)
    vals, idx = torch.topk(probs, k, dim=-1)
    if m["norm_topk_prob"]:
        vals = vals / vals.sum(-1, keepdim=True)
    vals = vals * m["routed_scaling_factor"]
    flat = x.reshape(b * t, d)
    y = torch.zeros_like(flat)
    for j in range(m["n_held"]):
        chosen = (idx == m["first_held"] + j).reshape(b * t, k)
        rows = chosen.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        w = (vals.reshape(b * t, k) * chosen).sum(-1)[rows]
        ex = {name: W[f"{prefix}.experts.{name}"] for name in
              ("wi_gate", "wi_up", "wo")}
        hx = F.silu(mm(flat[rows], pick(ex["wi_gate"])[j])) \
            * mm(flat[rows], pick(ex["wi_up"])[j])
        y = y.index_add(0, rows, mm(hx, pick(ex["wo"])[j]) * w[:, None])
    y = y.reshape(b, t, d) + swiglu(W, prefix + ".shared", pick, x, mm)
    f = F.one_hot(idx, e).to(x.dtype).sum((1, 2)) * (e / (k * t))   # [b, E]
    aux = (f * probs.mean(1)).sum(-1) * m["router_aux_weight"]
    return y, aux


def hidden(W, cfg, tokens, mm) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [b, T] -> (final normed hidden states [b, T, d], each
    row's balance loss summed over the MoE layers [b])."""
    eps = cfg["norm_eps"]
    x = W["embed"][tokens]

    def whole(t):
        return t
    x = x + mla(W, DENSE + ".attn", whole, rmsnorm(
        x, W[DENSE + ".ln1.scale"], eps), cfg, mm)
    x = x + swiglu(W, DENSE + ".ffn", whole,
                   rmsnorm(x, W[DENSE + ".ln2.scale"], eps), mm)
    aux = x.new_zeros(tokens.shape[0])
    for i in range(cfg["n_layers"] - 1):
        def pick(t, i=i):
            return t[i]
        x = x + mla(W, MOE + ".attn", pick, rmsnorm(
            x, pick(W[MOE + ".ln1.scale"]), eps), cfg, mm)
        y, a = moe(W, MOE + ".moe", pick, rmsnorm(
            x, pick(W[MOE + ".ln2.scale"]), eps), cfg, mm)
        x, aux = x + y, aux + a
    return rmsnorm(x, W["final_norm.scale"], eps), aux


def row_losses(W, cfg, tokens: torch.Tensor, mm) -> torch.Tensor:
    """tokens [b, T+1] -> each row's loss [b]: the mean over its T
    targets of ``logsumexp - logit[target] + z_loss * logsumexp^2``, plus
    its balance loss."""
    h, aux = hidden(W, cfg, tokens[:, :-1], mm)
    logits = mm(h, W["lm_head"])
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.take_along_dim(logits, tokens[:, 1:, None], dim=-1)[..., 0]
    return (lse - true + cfg["z_loss"] * lse.square()).mean(-1) + aux


# -- the first training steps -------------------------------------------------

def _norms_of(tensors: dict) -> dict:
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[k].float())
                        for k in names]).tolist()
    return dict(zip(names, vals))


def reference_steps(cfg: dict, job: dict, weights: dict, batches: list, *,
                    precision: str = "float32",
                    per_rank: Optional[Callable] = None) -> dict:
    """As :func:`portbench.reference.train.reference_steps`, for this
    family and the plain mean over the ranks (no error feedback): each
    step's mean loss, the first step's exchanged gradient and its norms,
    the norms of the parameters' change, and ``per_rank(r, grads)`` with
    each rank's own first gradient.  Parameters are kept in
    ``param_dtype`` between steps; a rank's rows are processed at once,
    one rank at a time."""
    if job.get("ef_compressor"):
        raise ValueError("the reference of this family models the plain "
                         "mean only, no error feedback")
    n, opt = job["ranks"], job["optimizer"]
    mm = matmul(precision)
    P = {k: w.detach().clone() for k, w in weights.items()}
    m = {k: torch.zeros(w.shape, dtype=torch.float32, device=w.device)
         for k, w in P.items()}
    v = {k: torch.zeros_like(x) for k, x in m.items()}
    out: dict = {"loss": []}
    with float32_matmuls():
        for s, batch in enumerate(batches):
            tokens = batch["tokens"]
            b = tokens.shape[0] // n
            W = {k: p.float().requires_grad_() for k, p in P.items()}
            names = list(W)
            gsum = {k: torch.zeros_like(x) for k, x in m.items()}
            loss = 0.0
            for r in range(n):
                lr_ = row_losses(W, cfg, tokens[r * b:(r + 1) * b], mm).mean()
                grads = torch.autograd.grad(lr_, [W[k] for k in names])
                loss = loss + lr_.detach()
                if s == 0 and per_rank is not None:
                    per_rank(r, dict(zip(names, grads)))
                for k, g in zip(names, grads):
                    gsum[k] += g
                del grads
            gmean = {k: x / n for k, x in gsum.items()}
            out["loss"].append(float(loss / n))
            if s == 0:
                out["grad_norms"] = _norms_of(gmean)
                out["first_grad"] = gmean
            t = s + 1
            c1, c2 = 1.0 - opt["b1"] ** t, 1.0 - opt["b2"] ** t
            with torch.no_grad():
                for k in names:
                    g = gmean[k]
                    m[k] = opt["b1"] * m[k] + (1 - opt["b1"]) * g
                    v[k] = opt["b2"] * v[k] + (1 - opt["b2"]) * g.square()
                    pf = P[k].float()
                    delta = (m[k] / c1) / (torch.sqrt(v[k] / c2)
                                           + opt["eps"]) \
                        + opt["weight_decay"] * pf
                    P[k] = (pf - opt["lr"] * delta).to(P[k].dtype)
            del W, gsum
    out["update_norms"] = _norms_of({k: P[k].float() - weights[k].float()
                                     for k in P})
    return out
