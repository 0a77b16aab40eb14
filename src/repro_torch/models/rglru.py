"""RG-LRU recurrent block (RecurrentGemma / Griffin) on the serving path.

    x1 = causal_conv(W_x u),  g = W_g u
    r_t = sigmoid(w_r ⊙ x1 + b_r)        (recurrence gate)
    i_t = sigmoid(w_i ⊙ x1 + b_i)        (input gate)
    a_t = exp(-c · softplus(Λ) · r_t)     (data-dependent decay, c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x1_t)
    y   = W_out (h ⊙ gelu(g))

The port of :mod:`repro.models.rglru` that serving runs.  The reference's
decode steps ``h = a*h + b`` in jnp and its prefill runs T decode steps;
here :func:`rglru_prefill` takes the whole prompt ``[B, T, D]`` and
launches the ``rglru_scan`` kernel once over T from the cached state, and
:func:`rglru_decode` is its T = 1 case.  The conv follows the decode
arithmetic (:func:`repro_torch.models.layers.conv1d_prefill`), continued
from the cache's window.  Both update the cache in place.  Training runs
the reference's plain forms under autograd (:func:`_affine_scan`,
:func:`rglru_block`), rank dims in front; the sequence-parallel scan
(``rglru_scan_sp``) waits for ROADMAP.md queue 1 item 9.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import chunk_scan as CS
from repro_torch.models import layers as L
from repro_torch.models.config import HybridConfig

PyTree = Any
_C = 8.0


def init_rglru(gen, d_model: int, cfg: HybridConfig, dtype=torch.bfloat16,
               *, device="cpu", lead: tuple[int, ...] = ()) -> PyTree:
    w = cfg.lru_width or d_model
    dense = dict(device=device, lead=lead)
    # Λ init so that a ∈ (0.9, 0.999) at r = 0.5 (Griffin appendix)
    lam = torch.log(torch.expm1(-2.0 * torch.log(
        L.uniform(gen, lead + (w,), device, 0.9, 0.999)) / _C))

    def zeros():
        return torch.zeros(lead + (w,), dtype=torch.float32, device=device)
    return {
        "wx": L.dense_init(gen, d_model, w, dtype, **dense),
        "wg": L.dense_init(gen, d_model, w, dtype, **dense),
        "conv": L.init_conv1d(gen, cfg.conv_width, w, dtype, **dense),
        "wout": L.dense_init(gen, w, d_model, dtype, **dense),
        "lam": lam,
        "w_r": zeros(), "b_r": zeros(), "w_i": zeros(), "b_i": zeros(),
    }


def _gates(p, x1):
    x1f = x1.to(torch.float32)

    def q(name):
        return L.lift(p[name], x1f)
    r = torch.sigmoid(q("w_r") * x1f + q("b_r"))
    i = torch.sigmoid(q("w_i") * x1f + q("b_i"))
    log_a = -_C * F.softplus(q("lam")) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * x1f)
    return a, b


# ---------------------------------------------------------------------------
# training (plain PyTorch under autograd, as the reference's jnp)
# ---------------------------------------------------------------------------

def _affine_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over dim -2 from h_{-1} = 0.  a, b: [...,
    B, T, W].

    A log-depth scan over the affine monoid (A, B)∘(A', B') = (A·A',
    A'·B + B'), as the reference's ``lax.associative_scan`` (whose
    association differs: equal up to rounding)."""
    A, B = a, b
    t, k = a.shape[-2], 1
    while k < t:
        A_lo = F.pad(A[..., :-k, :], (0, 0, k, 0), value=1.0)
        B_lo = F.pad(B[..., :-k, :], (0, 0, k, 0))
        A, B = A_lo * A, A * B_lo + B
        k *= 2
    return B


def rglru_block(p: PyTree, u: torch.Tensor, *,
                cfg: HybridConfig) -> torch.Tensor:
    """The reference's training block: u [..., B, T, D] -> [..., B, T,
    D]; rank-stacked params meet rank dims in front of u."""
    x1 = L.causal_conv1d(p["conv"], L.dense(u, p["wx"]))
    g = L.dense(u, p["wg"])
    a, b = _gates(p, x1)
    h = _affine_scan(a, b)
    y = h * F.gelu(g.to(torch.float32), approximate="tanh")
    return L.dense(y.to(u.dtype), p["wout"])


# ---------------------------------------------------------------------------
# serving (state caches: h and the conv window)
# ---------------------------------------------------------------------------

def init_rglru_cache(batch: int, cfg: HybridConfig, d_model: int,
                     dtype=torch.bfloat16, *, device="cpu",
                     lead: tuple[int, ...] = ()) -> PyTree:
    w = cfg.lru_width or d_model
    return {"h": torch.zeros(lead + (batch, w), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, w),
                                dtype=dtype, device=device)}


def rglru_prefill(p: PyTree, u: torch.Tensor, cache: PyTree, *,
                  use_kernels: bool = True) -> tuple[torch.Tensor, PyTree]:
    """T tokens through the block, continuing ``cache``.

    u: [B, T, D] (normed).  The conv continues from ``cache["conv"]`` and
    the recurrence from ``cache["h"]``, in one ``rglru_scan`` launch over
    the prompt (its plain version with ``use_kernels=False``).  Computes
    what T calls of :func:`rglru_decode` compute; the cache ends with the
    final state and the last ``conv_width - 1`` inputs, written in
    place.  Returns ([B, T, D] in u's dtype, cache)."""
    x = u @ p["wx"]
    x1, window = L.conv1d_prefill(p["conv"], cache["conv"], x)
    g = u @ p["wg"]
    a, b = _gates(p, x1)
    if use_kernels:
        h = CS.rglru_scan(a, b, cache["h"], h_out=cache["h"])
    else:
        h = CS.rglru_plain(a, b, cache["h"])
        cache["h"].copy_(h[:, -1])
    cache["conv"].copy_(window)
    y = h * F.gelu(g.to(torch.float32), approximate="tanh")
    return y.to(u.dtype) @ p["wout"], cache


def rglru_decode(p: PyTree, u_t: torch.Tensor, cache: PyTree, *,
                 use_kernels: bool = True) -> tuple[torch.Tensor, PyTree]:
    """u_t: [B, 1, D].  The one-token case of :func:`rglru_prefill`: one
    ``rglru_scan`` launch (T = 1) from the cached state, which it
    overwrites in place."""
    if u_t.shape[1] != 1:
        raise ValueError(f"rglru_decode takes one token, got u "
                         f"{tuple(u_t.shape)} (use rglru_prefill)")
    return rglru_prefill(p, u_t, cache, use_kernels=use_kernels)
