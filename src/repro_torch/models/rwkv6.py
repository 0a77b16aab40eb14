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
clones it first.  ``shard_act`` is dropped: without activation sharding
it is the identity (sharding is ROADMAP.md queue 1 item 9).  The chunked
training form (``wkv_chunked``) waits with training (queue 1 item 7).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import rwkv6_recurrence as RK
from repro_torch.models import layers as L

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
    """x_{t-1} stream.  x: [B, T, D]; x_prev: [B, D], the token before
    x[:, 0] (zeros when None, as at the start of a sequence)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, 0])
    if x.shape[1] == 1:
        return x_prev[:, None, :]
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], 1)


def _mix(mu: torch.Tensor, x: torch.Tensor,
         xs: torch.Tensor) -> torch.Tensor:
    return x + (xs - x) * mu.to(x.dtype)


def _wkv_inputs(p, x, xs):
    b, t, d = x.shape
    h = d // HEAD
    r = _mix(p["mu"]["r"], x, xs) @ p["wr"]
    k = _mix(p["mu"]["k"], x, xs) @ p["wk"]
    v = _mix(p["mu"]["v"], x, xs) @ p["wv"]
    g = _mix(p["mu"]["g"], x, xs) @ p["wg"]
    # the decay LoRA runs in the activation dtype, as in the reference;
    # only the exponentials are f32, and w stays f32 into the kernel
    xw = _mix(p["mu"]["w"], x, xs)
    dw = torch.tanh(xw @ p["w_lora_a"].to(xw.dtype)) \
        @ p["w_lora_b"].to(xw.dtype)
    w = torch.exp(-torch.exp(p["w0"] + dw.to(torch.float32)))

    def hd(z):
        return z.reshape(b, t, h, HEAD)
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
    """``x_prev`` ([B, D]) continues the token shift from a cache."""
    xs = _token_shift(x, x_prev)
    kk = torch.relu(_mix(p["mu"]["k"], x, xs) @ p["wk"]).square()
    rr = torch.sigmoid((_mix(p["mu"]["r"], x, xs) @ p["wr"])
                       .to(torch.float32)).to(x.dtype)
    return rr * (kk @ p["wv"])


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
