"""Base layers (pure-functional): norms, dense and embedding init, logits.

The part of :mod:`repro.models.layers` the ``ssm`` serving path needs.
Params are plain nested dicts of tensors; ``init_*`` builds them from an
explicit ``torch.Generator`` on a given device, with the reference's
distributions and dtypes (normals drawn in f32, then cast).  ``lead``
prefixes every shape, so a stacked layer's leaves come out ``[n, ...]``
in one draw, as the reference's ``vmap`` over layer keys gives them.  On
the ``meta`` device nothing is drawn: the leaves carry shape and dtype
only.  RoPE, the FFN variants and the causal conv wait with their
families (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

PyTree = Any


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def normal(gen: Optional[torch.Generator], shape: tuple[int, ...],
           device) -> torch.Tensor:
    """Standard normal f32 draws of ``shape`` (uninitialised on meta)."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def dense_init(gen, d_in: int, d_out: int, dtype=torch.bfloat16,
               scale: Optional[float] = None, *, device="cpu",
               lead: tuple[int, ...] = ()) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (normal(gen, lead + (d_in, d_out), device) * scale).to(dtype)


def embed_init(gen, vocab: int, d: int, dtype=torch.bfloat16, *,
               device="cpu") -> torch.Tensor:
    return normal(gen, (vocab, d), device).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype=torch.float32, *, device="cpu",
                 lead: tuple[int, ...] = ()) -> PyTree:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rmsnorm(p: PyTree, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Forward of the reference's ``_rmsnorm_fwd_impl``: f32 inside, the
    result in x's dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (xf * inv * p["scale"].to(torch.float32)).to(x.dtype)


def init_layernorm(d: int, dtype=torch.float32, *, device="cpu",
                   lead: tuple[int, ...] = ()) -> PyTree:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device),
            "bias": torch.zeros(lead + (d,), dtype=dtype, device=device)}


def layernorm(p: PyTree, x: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def init_norm(d: int, kind: str = "rms", *, device="cpu",
              lead: tuple[int, ...] = ()) -> PyTree:
    return init_layernorm(d, device=device, lead=lead) if kind == "layer" \
        else init_rmsnorm(d, device=device, lead=lead)


def apply_norm(p: PyTree, x: torch.Tensor, kind: str = "rms",
               eps: float = 1e-6) -> torch.Tensor:
    return layernorm(p, x, eps) if "bias" in p else rmsnorm(p, x, eps)


# ---------------------------------------------------------------------------
# embedding / logits
# ---------------------------------------------------------------------------

def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def logits_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [..., D] @ w: [D, V] in f32 for stable softmax/CE."""
    return x.to(torch.float32) @ w.to(torch.float32)
