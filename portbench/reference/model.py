"""Plain PyTorch forward passes and loss of the benchmark's model
families, written from the architectures' equations.

No kernel, cache or fused op: every product is ``mm`` (a plain matmul
in float32, or the control's fp8-rounded one, :func:`matmul`), every
attention a full softmax over explicit scores.  Weights come in as a
flat dict keyed by the paths of :mod:`.spec`; stacked leaves are
indexed by layer.  Nothing here reads the program.

  * dense: token embedding, per layer ``x += attn(rms(x))`` (RoPE,
    causal, grouped-query heads: query head ``h`` reads key/value head
    ``h // (n_heads / n_kv_heads)``), ``x += W_o(silu(W_g x) * W_u x)``
    on ``rms(x)``; final RMSNorm; logits in float32.
  * encdec: the encoder adds learned positions to the stub context and
    runs non-causal self attention and a GELU (tanh) FFN per layer, then
    a final LayerNorm; the decoder adds learned positions to the token
    embedding and runs causal self attention, cross attention over the
    encoder output and the FFN per layer, then a final LayerNorm.  No
    RoPE, no biases on projections.
  * logits: the final hidden states times ``lm_head``, or times the
    token embedding transposed where the configuration ties them.
  * loss: next-token cross entropy plus ``z_loss * logsumexp^2``, the
    mean over a row's target tokens.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor (its
    absmax maps to the format's largest value); the backward passes the
    gradient straight through, as fp8 training recipes do."""
    d = x.detach()
    s = d.abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (d / s).to(torch.float8_e4m3fn).to(d.dtype) * s
    return x + (q - d)


def matmul(precision: str) -> Callable:
    """The reference's product: ``float32`` (TF32 off, see
    :func:`float32_matmuls`) or ``fp8`` (both operands rounded to e4m3,
    the product accumulated in float32): the control."""
    if precision == "float32":
        return lambda x, w: x @ w
    if precision == "fp8":
        return lambda x, w: _fp8(x) @ _fp8(w)
    raise ValueError(f"unknown precision {precision!r}")


class float32_matmuls:
    """Within the block, float32 products stay float32 (no TF32)."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def layernorm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _norm(W, prefix, x, cfg, layer=None):
    pick = (lambda t: t) if layer is None else (lambda t: t[layer])
    scale = pick(W[prefix + ".scale"])
    if cfg["norm"] == "layer":
        return layernorm(x, scale, pick(W[prefix + ".bias"]),
                         cfg["norm_eps"])
    return rmsnorm(x, scale, cfg["norm_eps"])


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [b, T, H, d] at positions 0..T-1: the two halves of each head
    rotated by ``pos / theta^(2i/d)``."""
    t, d = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32,
                       device=x.device)[:, None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(W, prefix, layer, x, xc, cfg, mm, *, causal: bool,
              use_rope: bool) -> torch.Tensor:
    hd = cfg.get("d_head") or cfg["d_model"] // cfg["n_heads"]
    nh, nkv = cfg["n_heads"], cfg["n_kv_heads"]
    b, t, _ = x.shape
    tk = xc.shape[1]
    q = mm(x, W[prefix + ".wq"][layer]).reshape(b, t, nh, hd)
    k = mm(xc, W[prefix + ".wk"][layer]).reshape(b, tk, nkv, hd)
    v = mm(xc, W[prefix + ".wv"][layer]).reshape(b, tk, nkv, hd)
    if use_rope:
        q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    k = k.repeat_interleave(nh // nkv, dim=2)
    v = v.repeat_interleave(nh // nkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if causal:
        mask = torch.ones(t, tk, dtype=torch.bool, device=x.device).triu(1)
        s = s.masked_fill(mask, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return mm(o.reshape(b, t, nh * hd), W[prefix + ".wo"][layer])


def ffn(W, prefix, layer, x, cfg, mm) -> torch.Tensor:
    act = cfg["activation"]
    if act == "swiglu":
        h = F.silu(mm(x, W[prefix + ".wi_gate"][layer])) \
            * mm(x, W[prefix + ".wi_up"][layer])
    elif act == "gelu":
        h = F.gelu(mm(x, W[prefix + ".wi"][layer]), approximate="tanh")
    else:
        raise ValueError(f"no reference for activation {act!r}")
    return mm(h, W[prefix + ".wo"][layer])


def encode(W, cfg, context, mm) -> torch.Tensor:
    """Stub frame embeddings [b, Te, d] -> the encoder's output."""
    te = context.shape[1]
    x = context + W["enc.pos"][:te]
    blk = "enc.layers.pos0_enc_self"
    for i in range(cfg["encdec"]["n_encoder_layers"]):
        h = _norm(W, blk + ".ln1", x, cfg, i)
        x = x + attention(W, blk + ".attn", i, h, h, cfg, mm, causal=False,
                          use_rope=False)
        x = x + ffn(W, blk + ".ffn", i, _norm(W, blk + ".ln2", x, cfg, i),
                    cfg, mm)
    return _norm(W, "enc.final_norm", x, cfg)


def hidden(W, cfg, tokens, context, mm) -> torch.Tensor:
    """tokens [b, T] (and context [b, Te, d] for encdec) -> the final
    normed hidden states [b, T, d]."""
    x = W["embed"][tokens]
    n = cfg["n_layers"]
    if cfg["family"] == "dense":
        blk = "layers.pos0_self"
        for i in range(n):
            h = _norm(W, blk + ".ln1", x, cfg, i)
            x = x + attention(W, blk + ".attn", i, h, h, cfg, mm,
                              causal=True, use_rope=True)
            x = x + ffn(W, blk + ".ffn", i, _norm(W, blk + ".ln2", x, cfg,
                                                  i), cfg, mm)
    elif cfg["family"] == "encdec":
        mem = encode(W, cfg, context, mm)
        x = x + W["dec_pos"][:tokens.shape[1]]
        blk = "layers.pos0_dec_self_cross"
        for i in range(n):
            h = _norm(W, blk + ".ln1", x, cfg, i)
            x = x + attention(W, blk + ".attn", i, h, h, cfg, mm,
                              causal=True, use_rope=False)
            x = x + attention(W, blk + ".xattn", i,
                              _norm(W, blk + ".ln_x", x, cfg, i), mem, cfg,
                              mm, causal=False, use_rope=False)
            x = x + ffn(W, blk + ".ffn", i, _norm(W, blk + ".ln2", x, cfg,
                                                  i), cfg, mm)
    else:
        raise ValueError(f"no reference for family {cfg['family']!r}")
    return _norm(W, "final_norm", x, cfg)


def head(W, cfg) -> torch.Tensor:
    """The output projection [d, vocab]."""
    return W["embed"].t() if cfg.get("tie_embeddings") else W["lm_head"]


def row_losses(W, cfg, tokens: torch.Tensor,
               context: Optional[torch.Tensor], mm) -> torch.Tensor:
    """tokens [b, T+1] -> each row's mean loss [b] over its T targets:
    ``logsumexp - logit[target] + z_loss * logsumexp^2``."""
    h = hidden(W, cfg, tokens[:, :-1], context, mm)
    logits = mm(h, head(W, cfg))
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.take_along_dim(logits, tokens[:, 1:, None], dim=-1)[..., 0]
    return (lse - true + cfg["z_loss"] * lse.square()).mean(-1)
