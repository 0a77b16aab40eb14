"""Base layers (pure-functional): norms, dense and embedding init, RoPE,
the FFN variants, the causal temporal conv, logits.

The part of :mod:`repro.models.layers` the serving paths need.  Params
are plain nested dicts of tensors; ``init_*`` builds them from an
explicit ``torch.Generator`` on a given device, with the reference's
distributions and dtypes (normals drawn in f32, then cast).  ``lead``
prefixes every shape, so a stacked layer's leaves come out ``[n, ...]``
in one draw, as the reference's ``vmap`` over layer keys gives them.  On
the ``meta`` device nothing is drawn: the leaves carry shape and dtype
only.  :func:`ffn` pins its hidden activation with ``shard_act``
(:mod:`repro_torch.sharding.act`), as the reference does; no data moves.

Under tensor parallelism a weight may be a rank-stacked slice
``[*rank, d_in, d_out]`` (:mod:`repro_torch.serve.collectives`); then the
activations carry the same rank dims in front (or size-1 ones), and
:func:`dense` multiplies each rank's rows by its own slice.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.act import shard_act

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


def uniform(gen: Optional[torch.Generator], shape: tuple[int, ...], device,
            lo: float, hi: float) -> torch.Tensor:
    """Uniform f32 draws in ``[lo, hi)`` (uninitialised on meta)."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        lo, hi, generator=gen)


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


def lift(p: torch.Tensor, x: torch.Tensor, own: int = 1) -> torch.Tensor:
    """View a param ``p`` of shape ``[*rank, *own_dims]`` (``own`` dims
    of its own after any rank dims) so that it broadcasts against an
    activation ``x`` of ``[*rank, ..., *own_dims]`` rank by rank: size-1
    dims go in after the rank dims.  A param without rank dims comes
    back as it is."""
    r = p.dim() - own
    if r <= 0 or p.dim() >= x.dim():
        return p
    return p.reshape(p.shape[:r] + (1,) * (x.dim() - p.dim())
                     + p.shape[r:])


def _rmsnorm_fwd(scale, x, eps):
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    y = (xf * inv * lift(scale, xf).to(torch.float32)).to(x.dtype)
    return y, xf, inv


class _RMSNorm(torch.autograd.Function):
    """The reference's ``custom_vjp`` RMSNorm (``_rmsnorm_bwd``): the
    backward runs in f32 and the cotangent leaves in the primal dtype, so
    a bf16 residual stream keeps a bf16 cotangent chain.  ``dscale`` sums
    over every dim but the last and the scale's rank dims."""

    @staticmethod
    def forward(ctx, scale, x, eps):
        y, xf, inv = _rmsnorm_fwd(scale, x, eps)
        ctx.save_for_backward(scale, xf, inv)
        ctx.x_dtype = x.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        scale, xf, inv = ctx.saved_tensors
        gf = g.to(torch.float32)
        sf = lift(scale, gf).to(torch.float32)
        xhat = xf * inv
        r = scale.dim() - 1
        dscale = (gf * xhat).sum(tuple(range(r, gf.dim() - 1)))
        gx = gf * sf
        dx = inv * (gx - xhat * (gx * xhat).mean(-1, keepdim=True))
        return dscale.to(scale.dtype), dx.to(ctx.x_dtype), None


def rmsnorm(p: PyTree, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference's ``_rmsnorm``: f32 inside, the result in x's dtype;
    under autograd its ``custom_vjp`` backward (:class:`_RMSNorm`).  A
    rank-stacked scale ``[*rank, d]`` meets an ``x`` of ``[*rank, ...,
    d]``."""
    scale = p["scale"]
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(scale, x, eps)
    return _rmsnorm_fwd(scale, x, eps)[0]


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
    return (y * lift(p["scale"], y) + lift(p["bias"], y)).to(x.dtype)


def init_norm(d: int, kind: str = "rms", *, device="cpu",
              lead: tuple[int, ...] = ()) -> PyTree:
    return init_layernorm(d, device=device, lead=lead) if kind == "layer" \
        else init_rmsnorm(d, device=device, lead=lead)


def apply_norm(p: PyTree, x: torch.Tensor, kind: str = "rms",
               eps: float = 1e-6) -> torch.Tensor:
    return layernorm(p, x, eps) if "bias" in p else rmsnorm(p, x, eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float = 10000.0, *,
                     device="cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, *,
               freqs: Optional[torch.Tensor] = None,
               mscale: float = 1.0) -> torch.Tensor:
    """x: [..., T, H, d_head]; positions: [..., T] (absolute).  ``freqs``
    [d_head / 2] replaces RoPE's inverse frequencies and ``mscale``
    multiplies cos and sin (YaRN's, :mod:`repro_torch.models.mla`)."""
    d = x.shape[-1]
    if freqs is None:
        freqs = rope_frequencies(d, theta, device=x.device)    # [d/2]
    angles = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense products
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with jnp's dtype promotion (a bf16 operand meets an f32
    one in f32).  A weight with leading rank dims ``[*rank, d_in,
    d_out]`` meets an ``x`` of ``[*rank (or 1s), ..., d_in]``: every
    rank's rows, flattened into one matrix, go through that rank's slice
    in one batched product (the weight is never broadcast over x's
    batch dims, which would copy it)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    r = w.dim() - 2
    if not r:
        return x @ w
    rows = x.shape[r:-1]
    y = x.reshape(x.shape[:r] + (-1, x.shape[-1])) @ w
    return y.reshape(y.shape[:r] + rows + (w.shape[-1],))


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------

def init_ffn(gen, d: int, f: int, activation: str, dtype=torch.bfloat16,
             *, device="cpu", lead: tuple[int, ...] = ()) -> PyTree:
    dense = dict(device=device, lead=lead)
    if activation in ("swiglu", "geglu"):
        return {"wi_gate": dense_init(gen, d, f, dtype, **dense),
                "wi_up": dense_init(gen, d, f, dtype, **dense),
                "wo": dense_init(gen, f, d, dtype, **dense)}
    return {"wi": dense_init(gen, d, f, dtype, **dense),
            "wo": dense_init(gen, f, d, dtype, **dense)}


def ffn(p: PyTree, x: torch.Tensor, activation: str) -> torch.Tensor:
    """The reference's FFN; ``gelu`` is the tanh approximation, as
    ``jax.nn.gelu(approximate=True)``."""
    if activation == "swiglu":
        h = F.silu(dense(x, p["wi_gate"])) * dense(x, p["wi_up"])
    elif activation == "geglu":
        h = F.gelu(dense(x, p["wi_gate"]), approximate="tanh") \
            * dense(x, p["wi_up"])
    elif activation == "relu2":
        h = torch.relu(dense(x, p["wi"])).square()
    elif activation == "gelu":
        h = F.gelu(dense(x, p["wi"]), approximate="tanh")
    else:
        raise ValueError(f"unknown activation {activation!r}")
    h = shard_act(h, "dp", None, "tp")
    return dense(h, p["wo"])


# ---------------------------------------------------------------------------
# causal temporal conv (RG-LRU branch)
# ---------------------------------------------------------------------------

def init_conv1d(gen, width: int, channels: int, dtype=torch.bfloat16, *,
                device="cpu", lead: tuple[int, ...] = ()) -> PyTree:
    k = normal(gen, lead + (width, channels), device) / math.sqrt(width)
    return {"kernel": k.to(dtype),
            "bias": torch.zeros(lead + (channels,), dtype=dtype,
                                device=device)}


def causal_conv1d(p: PyTree, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, the reference's training form (a
    sum of shifted products in x's dtype).  x: [..., B, T, C]; a
    rank-stacked kernel ``[*rank, width, C]`` meets ``x`` of ``[*rank,
    B, T, C]``."""
    kern = p["kernel"]
    width, t = kern.shape[-2], x.shape[-2]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[..., i:i + t, :] * lift(kern[..., i, :], x)
    return out + lift(p["bias"], x)


def conv1d_prefill(p: PyTree, window: torch.Tensor, x: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """T steps of :func:`conv1d_decode` at once, with its arithmetic.

    window: [B, width-1, C] (the width-1 inputs before x); x: [B, T, C].
    Output t is the window ending at x_t times the kernel, summed in f32
    over the width and rounded once to x's dtype (the reference's einsum
    in the activation dtype), then ``+ bias`` in that dtype.  Returns
    (y [B, T, C], the last width-1 inputs)."""
    width = p["kernel"].shape[0]
    t = x.shape[1]
    full = torch.cat([window.to(x.dtype), x], dim=1)   # [B, width-1+T, C]
    kern = p["kernel"].to(torch.float32)
    acc = full[:, 0:t].to(torch.float32) * kern[0]
    for i in range(1, width):
        acc = acc + full[:, i:i + t].to(torch.float32) * kern[i]
    y = acc.to(x.dtype) + p["bias"].to(x.dtype)
    return y, full[:, t:]


def conv1d_decode(p: PyTree, window: torch.Tensor, x_t: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-step conv with a rolling window cache.

    window: [B, width-1, C] (the last width-1 inputs); x_t: [B, C].
    Returns (y_t, new_window)."""
    y, win = conv1d_prefill(p, window, x_t[:, None, :])
    return y[:, 0], win


# ---------------------------------------------------------------------------
# embedding / logits
# ---------------------------------------------------------------------------

def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; a rank-stacked table ``[*rank, V, d]`` meets ids
    of ``[*rank, ...]``, every rank gathering from its own table."""
    r = table.dim() - 2
    if r <= 0:
        return table[ids]
    grids = tuple(torch.arange(s, device=ids.device).reshape(
        (1,) * j + (s,) + (1,) * (ids.dim() - j - 1))
        for j, s in enumerate(table.shape[:r]))
    return table[grids + (ids,)]


def logits_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [..., D] @ w: [D, V] (or rank-stacked ``[*rank, D, V]``) in f32
    for stable softmax/CE."""
    return dense(x.to(torch.float32), w.to(torch.float32))
