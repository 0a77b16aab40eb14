"""RWKV-6 "Finch" block on the serving path: WKV6 token mix + channel mix.

The port of :mod:`repro.models.rwkv6` that serving runs:

Token mix (per head, head dim K = V = 64):
    token-shift lerp (learned μ per channel) feeds r, k, v, g and the
    decay LoRA:  w_t = exp(-exp(w0 + tanh(x̄ A) B))  (data-dependent)
    o_t = WKV(r, k, v, w, u)   — the ``rwkv6_recurrence`` kernel
    out = W_o (rmsnorm(o) ⊙ silu(g))

Channel mix:
    out = sigmoid(W_r x̄r) ⊙ (W_v relu(W_k x̄k)²)

The reference's decode computes the one-token WKV in plain jnp and its
prefill runs T decode steps; here both go through :func:`wkv`, which
launches the kernel once per layer for the token or the whole prompt.
:func:`rwkv6_prefill` is the ``[B, T, D]`` form of :func:`rwkv6_decode`
and computes what T calls of it compute.  Both update the cache in place
(the reference engine donates it); a caller that needs the old cache
clones it first.  The WKV inputs are pinned with ``shard_act``
(:mod:`repro_torch.sharding.act`) as in the reference; no data moves.

Training runs the reference's plain forms under autograd, no kernel:
:func:`rwkv6_token_mix` with :func:`wkv_chunked` at ``T >= 64``, else
the kernel's plain version (the reference's ``wkv``).  Every training
function takes rank dims in front of ``[B, T, ...]`` and rank-stacked
params (the train step's per-rank gradients).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_recurrence as RK
from repro_torch.models import layers as L
from repro_torch.sharding.act import shard_act

PyTree = Any
HEAD = 64
LORA = 64


def init_rwkv6(gen, d: int, dtype=torch.bfloat16, *, device="cpu",
               lead: tuple[int, ...] = ()) -> PyTree:
    h = d // HEAD
    dense = dict(device=device, lead=lead)
    return {
        "mu": {name: torch.full(lead + (d,), 0.5, device=device)
               for name in ("r", "k", "v", "g", "w")},
        "wr": L.dense_init(gen, d, d, dtype, **dense),
        "wk": L.dense_init(gen, d, d, dtype, **dense),
        "wv": L.dense_init(gen, d, d, dtype, **dense),
        "wg": L.dense_init(gen, d, d, dtype, **dense),
        "wo": L.dense_init(gen, d, d, dtype, **dense),
        "w0": torch.full(lead + (d,), -6.0, device=device),  # w ≈ 1-2e-3
        "w_lora_a": L.dense_init(gen, d, LORA, torch.float32, scale=0.01,
                                 **dense),
        "w_lora_b": L.dense_init(gen, LORA, d, torch.float32, scale=0.01,
                                 **dense),
        "u": 0.1 * L.normal(gen, lead + (h, HEAD), device),
        "ln_o": L.init_rmsnorm(d, device=device, lead=lead),
    }


def _token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """x_{t-1} stream.  x: [..., B, T, D]; x_prev: [..., B, D], the token
    before x[..., 0, :] (zeros when None, as at the start of a
    sequence)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[..., 0, :])
    if x.shape[-2] == 1:
        return x_prev[..., None, :]
    return torch.cat([x_prev[..., None, :], x[..., :-1, :]], -2)


def _mix(mu: torch.Tensor, x: torch.Tensor,
         xs: torch.Tensor) -> torch.Tensor:
    return x + (xs - x) * L.lift(mu, x).to(x.dtype)


def _wkv_inputs(p, x, xs):
    d = x.shape[-1]
    h = d // HEAD
    r = L.dense(_mix(p["mu"]["r"], x, xs), p["wr"])
    k = L.dense(_mix(p["mu"]["k"], x, xs), p["wk"])
    v = L.dense(_mix(p["mu"]["v"], x, xs), p["wv"])
    g = L.dense(_mix(p["mu"]["g"], x, xs), p["wg"])
    # the decay LoRA runs in the activation dtype, as in the reference;
    # only the exponentials are f32, and w stays f32 into the kernel
    xw = _mix(p["mu"]["w"], x, xs)
    dw = L.dense(torch.tanh(L.dense(xw, p["w_lora_a"].to(xw.dtype))),
                 p["w_lora_b"].to(xw.dtype))
    w = torch.exp(-torch.exp(L.lift(p["w0"], dw) + dw.to(torch.float32)))

    def hd(z):
        return shard_act(z.reshape(z.shape[:-1] + (h, HEAD)),
                         "dp", None, "tp", None)
    return hd(r), hd(k), hd(v), g, hd(w)


def wkv(r, k, v, w, u, s0=None, *, kv_bf16: bool = False,
        s_out: Optional[torch.Tensor] = None, use_kernels: bool = True):
    """Batched multi-head WKV6.  r,k,w: [B,T,H,K], v: [B,T,H,V], u: [H,K].

    Returns (o: [B,T,H,V] in v's dtype, s_final: [B,H,K,V] f32), the
    final state written into ``s_out`` when given (it may be ``s0``).
    With ``use_kernels`` the ``rwkv6_recurrence`` kernel computes it (the
    plain version on a CPU tensor); without, the plain version on any
    device.  The kernel reads the ``[B, H, T, ·]`` views in place and
    writes o in v's layout, so no copy is made.
    """
    hv = [z.transpose(1, 2) for z in (r, k, v, w)]
    if use_kernels:
        o, s = RK.rwkv6_recurrence(*hv, u, s0, kv_bf16=kv_bf16,
                                   s_out=s_out)
    else:
        o, s = RK.plain(*hv, u, s0, kv_bf16=kv_bf16)
        if s_out is not None:
            s = s_out.copy_(s)
    return o.transpose(1, 2), s


# ---------------------------------------------------------------------------
# training forms (plain PyTorch under autograd, as the reference's jnp)
# ---------------------------------------------------------------------------

def wkv_chunked(r, k, v, w, u, *, chunk: int = 32):
    """The reference's chunked-parallel WKV6 (its MXU training path),
    equal to the plain recurrence up to rounding: time runs in chunks,
    intra-chunk interactions are masked [C, C] products with the decay
    factored around the chunk's midpoint (``L`` the cumulative log-decay,
    ``L_h`` its value at the midpoint), inter-chunk flows through the
    carried state with non-positive exponents.  r,k,w [..., B, T, H, K],
    v [..., B, T, H, V], u [..., H, K] (rank dims in front, or none);
    returns (o [..., B, T, H, V] in v's dtype, s_final [..., B, H, K, V]
    f32).  Extreme decays (w → 0) need a smaller ``chunk``."""
    lead = r.shape[:-3]
    t, h, kk = r.shape[-3:]
    vv = v.shape[-1]
    c = min(chunk, t)
    pad = (-t) % c
    f32 = [z.to(torch.float32) for z in (r, k, v, w)]
    if pad:
        f32 = [F.pad(z, (0, 0, 0, 0, 0, pad), value=1.0 if i == 3 else 0.0)
               for i, z in enumerate(f32)]
    tp = t + pad
    nc = tp // c

    def resh(z):                              # -> [NC, ..., H, C, dd]
        return z.reshape(lead + (nc, c, h, z.shape[-1])) \
            .movedim(-4, 0).transpose(-3, -2)

    rc, kc, vc, wc = (resh(z) for z in f32)
    uu = L.lift(u, r[..., 0, :, :], own=2)[..., None, :]  # [.., H, 1, K]
    S = torch.zeros(lead + (h, kk, vv), dtype=torch.float32,
                    device=r.device)
    mask_lt = torch.tril(torch.ones((c, c), dtype=torch.float32,
                                    device=r.device), diagonal=-1)
    outs = []
    for i in range(nc):
        rr, kk_, vv_, ww = rc[i], kc[i], vc[i], wc[i]       # [.., H, C, ·]
        lw = torch.log(torch.clamp_min(ww, 1e-30))
        Lc = torch.cumsum(lw, dim=-2)                      # inclusive
        L_prev = Lc - lw                                   # exclusive
        L_half = Lc[..., c // 2:c // 2 + 1, :]
        q_in = rr * torch.exp(L_prev - L_half)
        k_in = kk_ * torch.exp(L_half - Lc)
        A = torch.einsum("...tk,...sk->...ts", q_in, k_in) * mask_lt
        o = torch.einsum("...ts,...sv->...tv", A, vv_)
        # diagonal (current-token u-boosted) term
        o = o + torch.einsum("...tk,...tv->...tv", rr * uu * kk_, vv_)
        # inter-chunk: state contribution (exponents <= 0)
        o = o + torch.einsum("...tk,...kv->...tv", rr * torch.exp(L_prev), S)
        # state update
        k_dec = kk_ * torch.exp(Lc[..., -1:, :] - Lc)
        S = torch.exp(Lc[..., -1, :])[..., None] * S + \
            torch.einsum("...tk,...tv->...kv", k_dec, vv_)
        outs.append(o)
    o = torch.stack(outs, 0).transpose(-3, -2).movedim(0, -4) \
        .reshape(lead + (tp, h, vv))[..., :t, :, :]
    return o.to(v.dtype), S


def rwkv6_token_mix(p: PyTree, x: torch.Tensor, *,
                    chunk: int = 32) -> torch.Tensor:
    """The reference's training token mix over x [..., B, T, D]: the
    chunked WKV at ``T >= 64``, else the kernel's plain version (a loop
    over T in f32, the reference's ``wkv``) on the ``[..., H, T, ·]``
    views, u lifted past the batch dim."""
    xs = _token_shift(x)
    r, k, v, g, w = _wkv_inputs(p, x, xs)
    if x.shape[-2] >= 64:
        o, _ = wkv_chunked(r, k, v, w, p["u"], chunk=chunk)
    else:
        o, _ = ref.rwkv6_recurrence(
            *(z.transpose(-3, -2) for z in (r, k, v, w)),
            L.lift(p["u"], r[..., 0, :, :], own=2))
        o = o.transpose(-3, -2)
    o = L.rmsnorm(p["ln_o"], o.reshape(x.shape))
    return L.dense(o * F.silu(g.to(o.dtype)), p["wo"])


def init_channel_mix(gen, d: int, f: int, dtype=torch.bfloat16, *,
                     device="cpu", lead: tuple[int, ...] = ()) -> PyTree:
    dense = dict(device=device, lead=lead)
    return {
        "mu": {name: torch.full(lead + (d,), 0.5, device=device)
               for name in ("k", "r")},
        "wk": L.dense_init(gen, d, f, dtype, **dense),
        "wv": L.dense_init(gen, f, d, dtype, **dense),
        "wr": L.dense_init(gen, d, d, dtype, **dense),
    }


def rwkv6_channel_mix(p: PyTree, x: torch.Tensor,
                      x_prev: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """``x_prev`` ([..., B, D]) continues the token shift from a cache."""
    xs = _token_shift(x, x_prev)
    kk = torch.relu(L.dense(_mix(p["mu"]["k"], x, xs), p["wk"])).square()
    rr = torch.sigmoid(L.dense(_mix(p["mu"]["r"], x, xs), p["wr"])
                       .to(torch.float32)).to(x.dtype)
    return rr * L.dense(kk, p["wv"])


# ---------------------------------------------------------------------------
# serving (state caches: WKV state + last-token shifts)
# ---------------------------------------------------------------------------

def init_rwkv6_cache(batch: int, d: int, dtype=torch.bfloat16, *,
                     device="cpu", lead: tuple[int, ...] = ()) -> PyTree:
    h = d // HEAD
    return {"s": torch.zeros(lead + (batch, h, HEAD, HEAD),
                             dtype=torch.float32, device=device),
            "x_tok": torch.zeros(lead + (batch, d), dtype=dtype,
                                 device=device),
            "x_ch": torch.zeros(lead + (batch, d), dtype=dtype,
                                device=device)}


def rwkv6_prefill(p_tok: PyTree, p_ch: PyTree, x: torch.Tensor,
                  cache: PyTree, norm_tok, norm_ch, *,
                  use_kernels: bool = True) -> tuple[torch.Tensor, PyTree]:
    """T tokens through token mix + channel mix, continuing ``cache``.

    x: [B, T, D] (post-embedding); the norms are applied here, so the
    carried shifts are the normed streams.  The token shifts start from
    ``cache["x_tok"]``/``cache["x_ch"]`` and the WKV from ``cache["s"]``,
    in one kernel launch over the whole prompt (kv rounded to bf16 when
    k and v are bf16, as the reference's decode forms it).  Computes what
    T calls of :func:`rwkv6_decode` compute; the cache ends with the
    final state and the last token's normed inputs, written in place.
    """
    b, t, d = x.shape
    xn = norm_tok(x)
    xs = _token_shift(xn, cache["x_tok"])
    r, k, v, g, w = _wkv_inputs(p_tok, xn, xs)
    o, _ = wkv(r, k, v, w, p_tok["u"], cache["s"],
               kv_bf16=k.dtype == torch.bfloat16, s_out=cache["s"],
               use_kernels=use_kernels)
    o = L.rmsnorm(p_tok["ln_o"], o.reshape(b, t, d).to(x.dtype))
    x = x + (o * F.silu(g.to(o.dtype))) @ p_tok["wo"]

    xn2 = norm_ch(x)
    x = x + rwkv6_channel_mix(p_ch, xn2, cache["x_ch"])
    # the shifts above read the cache: overwrite it only now
    cache["x_tok"].copy_(xn[:, -1])
    cache["x_ch"].copy_(xn2[:, -1])
    return x, cache


def rwkv6_decode(p_tok: PyTree, p_ch: PyTree, x: torch.Tensor,
                 cache: PyTree, norm_tok, norm_ch, *,
                 use_kernels: bool = True) -> tuple[torch.Tensor, PyTree]:
    """One token through token-mix + channel-mix with carried state.

    x: [B, 1, D] (post-embedding).  The one-token case of
    :func:`rwkv6_prefill`: one ``rwkv6_recurrence`` launch (T = 1) from
    the cached state, which it overwrites in place.
    """
    if x.shape[1] != 1:
        raise ValueError(f"rwkv6_decode takes one token, got x "
                         f"{tuple(x.shape)} (use rwkv6_prefill)")
    return rwkv6_prefill(p_tok, p_ch, x, cache, norm_tok, norm_ch,
                         use_kernels=use_kernels)
