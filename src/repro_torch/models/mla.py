"""Multi-head Latent Attention (DeepSeek-V2).

The port of :mod:`repro.models.mla`.  KV is compressed to a low-rank
latent ``c_kv`` [B, T, kv_lora] plus one rope key shared by every head
[B, T, rope_dim]; the decode cache holds only those two, 512 + 64 values
a token at deepseek-v2-236b's width against 2·128·128 for the per-head
keys and values of a 128-head cache.

Attention runs in latent space by the absorbed-projection trick
(:func:`_attend`): the queries are lifted by ``W_ukᵀ`` in f32, one MQA
flash attention runs with the single shared key ``c_kv ⊕ k_rope`` and
value ``c_kv``, and the result goes through ``W_uv``; per-head keys and
values are never formed.  The casts match the reference's one for one:
f32 inside, the bf16 caches widened at every step, the output rounded to
x's dtype before ``wo``.

Full sequences on the card attend in the per-head form instead
(:func:`_attend_per_head`): keys ``[W_uk c_kv ; k_rope]`` (nope + rope
wide, the rope key broadcast to every head) and values ``W_uv c_kv`` in
x's dtype, through the fused kernel, which takes them at (192, 128).
One rule picks the form (:func:`per_head`): per-head where the fused
kernel takes the call, the absorbed form for decode, on the CPU and for
every call the kernel refuses.  Training wants the per-head form:
the absorbed one runs 576-wide f32 queries against one shared key, which
no kernel takes.

With ``cfg.yarn`` (DeepSeek-V2's YaRN rope scaling) the rope key and
queries rotate by YaRN's frequencies (:func:`rope_frequencies`) and the
softmax scale is ``(nope + rope)^-1/2 · m²``, ``m = 0.1 · mscale_all_dim
· ln(factor) + 1`` (:func:`softmax_scale`).  While spans are recorded a
whole-sequence call runs under the span ``mla.attention``, from its
projections to ``wo``.

Every function takes leading dims before ``[B, T, ...]``: under the train
step's rank dims the params are rank-stacked ``[*rank, ...]`` and meet
activations ``[*rank, B, T, D]`` (:func:`repro_torch.models.layers.dense`).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as L
from repro_torch.models.attention import flash_attention
from repro_torch.models.config import MLAConfig, YarnConfig
from repro_torch.obs import spans as _spans

PyTree = Any


def init_mla(gen, d_model: int, n_heads: int, cfg: MLAConfig,
             dtype=torch.bfloat16, *, device="cpu",
             lead: tuple[int, ...] = ()) -> PyTree:
    qdim = cfg.nope_head_dim + cfg.rope_head_dim
    kw = dict(device=device, lead=lead)
    p = {
        "w_dkv": L.dense_init(gen, d_model, cfg.kv_lora + cfg.rope_head_dim,
                              dtype, **kw),
        "kv_norm": L.init_rmsnorm(cfg.kv_lora, **kw),
        "w_uk": L.dense_init(gen, cfg.kv_lora, n_heads * cfg.nope_head_dim,
                             dtype, **kw),
        "w_uv": L.dense_init(gen, cfg.kv_lora, n_heads * cfg.v_head_dim,
                             dtype, **kw),
        "wo": L.dense_init(gen, n_heads * cfg.v_head_dim, d_model, dtype,
                           **kw),
    }
    if cfg.q_lora:
        p["w_dq"] = L.dense_init(gen, d_model, cfg.q_lora, dtype, **kw)
        p["q_norm"] = L.init_rmsnorm(cfg.q_lora, **kw)
        p["w_uq"] = L.dense_init(gen, cfg.q_lora, n_heads * qdim, dtype,
                                 **kw)
    else:
        p["wq"] = L.dense_init(gen, d_model, n_heads * qdim, dtype, **kw)
    return p


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def rope_frequencies(cfg: MLAConfig, theta: float, device="cpu"
                     ) -> torch.Tensor:
    """The rope key's inverse frequencies [rope_head_dim / 2]: RoPE's, or
    with ``cfg.yarn`` YaRN's (``DeepseekV2YarnRotaryEmbedding``): the
    frequencies interpolated by ``factor`` below the correction range of
    ``beta_fast`` .. ``beta_slow`` rotations over ``original_max``
    positions, kept above it, blended linearly across it."""
    d = cfg.rope_head_dim
    freq = L.rope_frequencies(d, theta, device=device)
    y = cfg.yarn
    if y is None:
        return freq

    def dim_of(rotations):
        return d * math.log(y.original_max / (rotations * 2 * math.pi)) \
            / (2 * math.log(theta))
    low = max(math.floor(dim_of(y.beta_fast)), 0)
    high = min(math.ceil(dim_of(y.beta_slow)), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    return freq / y.factor * ramp + freq * (1 - ramp)


def rope_mscale(y: YarnConfig) -> float:
    """YaRN's factor on cos and sin: ``m(mscale) / m(mscale_all_dim)``."""
    return _yarn_mscale(y.factor, y.mscale) / _yarn_mscale(
        y.factor, y.mscale_all_dim)


def softmax_scale(cfg: MLAConfig) -> float:
    """``(nope + rope)^-1/2``, times ``m(mscale_all_dim)²`` under YaRN."""
    scale = 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    y = cfg.yarn
    if y is not None and y.mscale_all_dim:
        scale *= _yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return scale


def _rope(x, positions, cfg, rope_theta):
    """RoPE over x [..., T, H, rope] by :func:`rope_frequencies`."""
    if cfg.yarn is None:
        return L.apply_rope(x, positions, rope_theta)
    return L.apply_rope(x, positions, rope_theta,
                        freqs=rope_frequencies(cfg, rope_theta, x.device),
                        mscale=rope_mscale(cfg.yarn))


def _queries(p, x, n_heads, cfg, positions, rope_theta):
    """x [..., B, T, D] -> (q_nope, q_rope) [..., B, T, H, ·]."""
    qdim = cfg.nope_head_dim + cfg.rope_head_dim
    if "w_dq" in p:
        q = L.dense(L.rmsnorm(p["q_norm"], L.dense(x, p["w_dq"])), p["w_uq"])
    else:
        q = L.dense(x, p["wq"])
    q = q.reshape(q.shape[:-1] + (n_heads, qdim))
    q_nope = q[..., :cfg.nope_head_dim]
    q_rope = _rope(q[..., cfg.nope_head_dim:], positions, cfg, rope_theta)
    return q_nope, q_rope


def _latents(p, x, cfg, positions, rope_theta):
    """x [..., B, T, D] -> (c_kv [..., B, T, kv_lora], k_rope [..., B, T,
    rope]): the rope key gets RoPE as a one-head tensor."""
    dkv = L.dense(x, p["w_dkv"])
    c_kv = L.rmsnorm(p["kv_norm"], dkv[..., :cfg.kv_lora])
    k_rope = _rope(dkv[..., cfg.kv_lora:][..., None, :], positions, cfg,
                   rope_theta)[..., 0, :]
    return c_kv, k_rope


def _per_head(w: torch.Tensor, n_heads: int, d: int) -> torch.Tensor:
    """A projection [..., kv_lora, H * d] as [..., kv_lora, H, d] in f32."""
    return w.reshape(w.shape[:-1] + (n_heads, d)).to(torch.float32)


def _attend(p, q_nope, q_rope, c_kv, k_rope, n_heads, cfg, *, causal,
            q_offset, kv_len=None, chunk=1024):
    """Latent-space attention via the absorbed-projection trick.

    score = q_nope·(W_uk c) + q_rope·k_rope = (W_ukᵀ q_nope ⊕ q_rope)·(c ⊕
    k_rope): an MQA flash attention with the shared key (c_kv ⊕ k_rope)
    and value c_kv, the context lifted through W_uv after the softmax.
    The softmax scale is that of the per-head key (:func:`softmax_scale`).
    Returns [..., B, Tq, H * v_head_dim] f32."""
    scale = softmax_scale(cfg)
    w_uk = _per_head(p["w_uk"], n_heads, cfg.nope_head_dim)
    q_lat = torch.einsum("...bqhd,...khd->...bqhk",
                         q_nope.to(torch.float32), w_uk)
    q_eff = torch.cat([q_lat, q_rope.to(torch.float32)], dim=-1)
    k_eff = torch.cat([c_kv, k_rope], dim=-1)[..., None, :]
    v_eff = c_kv[..., None, :]
    ctx_lat = flash_attention(
        q_eff, k_eff.to(torch.float32), v_eff.to(torch.float32),
        causal=causal, q_offset=q_offset, kv_len=kv_len, chunk=chunk,
        softmax_scale=scale)                        # [..., B, Tq, H, kv_lora]
    w_uv = _per_head(p["w_uv"], n_heads, cfg.v_head_dim)
    out = torch.einsum("...bqhk,...khv->...bqhv",
                       ctx_lat.to(torch.float32), w_uv)
    return out.reshape(out.shape[:-2] + (n_heads * cfg.v_head_dim,))


def _attend_per_head(p, q_nope, q_rope, c_kv, k_rope, n_heads, cfg, *,
                     q_offset, chunk=1024):
    """Causal attention over per-head keys ``[W_uk c ; k_rope]`` and
    values ``W_uv c`` formed in the activations' dtype: the algebra of
    :func:`_attend` without the absorption.  Returns [..., B, Tq, H *
    v_head_dim] in that dtype."""
    k_nope = L.dense(c_kv, p["w_uk"])
    k_nope = k_nope.reshape(k_nope.shape[:-1] + (n_heads, cfg.nope_head_dim))
    k = torch.cat([k_nope, k_rope[..., None, :].expand(
        k_rope.shape[:-1] + (n_heads, cfg.rope_head_dim)).to(k_nope.dtype)],
        dim=-1)
    v = L.dense(c_kv, p["w_uv"])
    v = v.reshape(v.shape[:-1] + (n_heads, cfg.v_head_dim))
    q = torch.cat([q_nope, q_rope.to(q_nope.dtype)], dim=-1)
    out = flash_attention(q, k, v, causal=True, q_offset=q_offset,
                          chunk=chunk, softmax_scale=softmax_scale(cfg))
    return out.reshape(out.shape[:-2] + (n_heads * cfg.v_head_dim,))


def per_head(x: torch.Tensor, cfg: MLAConfig, q_offset) -> bool:
    """The rule that picks the form of a whole-sequence call: per-head
    on the card for bf16 activations, an int ``q_offset`` and widths the
    fused kernel is built for (its ``takes`` then holds for the causal
    self attention), else absorbed."""
    return (x.is_cuda and x.dtype == torch.bfloat16
            and isinstance(q_offset, int) and q_offset >= 0
            and FA.widths(cfg.nope_head_dim + cfg.rope_head_dim,
                          cfg.v_head_dim))


def mla_attention(p: PyTree, x: torch.Tensor, *, n_heads: int,
                  cfg: MLAConfig, rope_theta: float = 10000.0,
                  q_offset: int = 0, chunk: int = 1024) -> torch.Tensor:
    """Causal MLA over a whole sequence x [..., B, T, D] from position
    ``q_offset``, in the form :func:`per_head` picks."""
    with _spans.span("mla.attention"):
        t = x.shape[-2]
        pos = (q_offset + torch.arange(t, device=x.device))[None]
        q_nope, q_rope = _queries(p, x, n_heads, cfg, pos, rope_theta)
        c_kv, k_rope = _latents(p, x, cfg, pos, rope_theta)
        if per_head(x, cfg, q_offset):
            out = _attend_per_head(p, q_nope, q_rope, c_kv, k_rope, n_heads,
                                   cfg, q_offset=q_offset, chunk=chunk)
        else:
            out = _attend(p, q_nope, q_rope, c_kv, k_rope, n_heads, cfg,
                          causal=True, q_offset=q_offset, chunk=chunk)
        return L.dense(out.to(x.dtype), p["wo"])


def init_mla_cache(batch: int, seq: int, cfg: MLAConfig,
                   dtype=torch.bfloat16, *, device="cpu",
                   lead: tuple[int, ...] = ()) -> PyTree:
    return {"c_kv": torch.zeros(lead + (batch, seq, cfg.kv_lora),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros(lead + (batch, seq, cfg.rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_decode(p: PyTree, x: torch.Tensor, cache: PyTree, index, *,
               n_heads: int, cfg: MLAConfig, rope_theta: float = 10000.0
               ) -> tuple[torch.Tensor, PyTree]:
    """One token x [B, 1, D] against the latent cache {c_kv, k_rope: [B,
    S, ·]}, written in place.  ``index``: a scalar (an int or a 0-dim
    tensor: the token's latents go to position ``index`` of every row) or
    an integer [B] tensor (continuous batching: one row each); the query
    attends over positions ``[0, index]`` of its row."""
    b = x.shape[-3]
    dev = x.device
    vec = torch.is_tensor(index) and index.dim() > 0
    if vec:
        idx = index.to(device=dev, dtype=torch.int64)
        pos = idx[:, None]
    elif isinstance(index, int):
        idx = index
        pos = torch.full((b, 1), index, dtype=torch.int64, device=dev)
    else:
        idx = torch.as_tensor(index, device=dev).to(torch.int64)
        pos = idx.reshape(1, 1).expand(b, 1)
    q_nope, q_rope = _queries(p, x, n_heads, cfg, pos, rope_theta)
    c_new, kr_new = _latents(p, x, cfg, pos, rope_theta)
    for name, new in (("c_kv", c_new), ("k_rope", kr_new)):
        buf = cache[name]
        if vec:
            rows = torch.arange(b, device=dev)
            buf[..., rows, idx, :] = new[..., 0, :].to(buf.dtype)
        elif isinstance(idx, int):
            buf[..., idx:idx + 1, :] = new.to(buf.dtype)
        else:
            buf.index_copy_(buf.dim() - 2, idx.reshape(1), new.to(buf.dtype))
    out = _attend(p, q_nope, q_rope, cache["c_kv"], cache["k_rope"], n_heads,
                  cfg, causal=False, q_offset=idx, kv_len=idx + 1)
    return L.dense(out.to(x.dtype), p["wo"]), cache
