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
:func:`rglru_block`), rank dims in front.  :func:`rglru_scan_sp` is the
sequence-parallel scan: every rank a chunk of T, the chunks joined by the
exclusive rank scan of the affine monoid (the ``rglru_scan`` kernel
computes the local scans on the card).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import chunk_scan as CS
from repro_torch.models import layers as L
from repro_torch.models.config import HybridConfig
from repro_torch.sharding.act import shard_act

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
    x1 = shard_act(L.causal_conv1d(p["conv"], L.dense(u, p["wx"])),
                   "dp", None, "tp")
    g = shard_act(L.dense(u, p["wg"]), "dp", None, "tp")
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


# ---------------------------------------------------------------------------
# sequence-parallel scan (ACiS Type 3 joins the chunks across ranks)
# ---------------------------------------------------------------------------

def _affine(lo, hi):
    """(A, B) ∘ (A', B') = (A·A', A'·B + B'): ``lo`` the earlier ranks'
    span, ``hi`` the later one (non-commutative)."""
    return lo[0] * hi[0], hi[0] * lo[1] + hi[1]


def _affine_identity(s):
    return (torch.ones(s[0].shape, dtype=s[0].dtype, device=s[0].device),
            torch.zeros(s[1].shape, dtype=s[1].dtype, device=s[1].device))


def rglru_scan_sp(a: torch.Tensor, b: torch.Tensor,
                  axis_name: str) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` over a T split into contiguous chunks,
    one a rank along ``axis_name`` (inside ``with mesh:``); a, b:
    rank-stacked ``[*rank, B, T/n, W]`` f32.

    Each rank scans its chunk from ``h0 = 0`` — every rank's chunk in one
    ``rglru_scan`` launch over ``[*rank, B, T/n, W]`` when the inputs are
    on the card and need no gradient, else :func:`_affine_scan` — then
    the cross-rank carry is the exclusive rank scan
    (:func:`repro_torch.core.ring.rank_prefix_scan`) of ``(Π a, h_last)``
    under the affine monoid: the look-aside carry walking the network.
    ``h = h_local + cumprod(a) · carry``."""
    from repro_torch.core.ring import rank_prefix_scan
    from repro_torch.core.types import Monoid

    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if not grad and a.device.type == "cuda":
        h = CS.rglru_scan(a.contiguous(), b.contiguous())
    else:
        h = _affine_scan(a, b)
    affine = Monoid("affine", _affine, _affine_identity, commutative=False)
    _, carry = rank_prefix_scan((torch.prod(a, dim=-2), h[..., -1, :]),
                                axis_name, affine, exclusive=True)
    a_cum = torch.cumprod(a, dim=-2)
    if grad:
        return h + a_cum * carry[..., None, :]
    # in place: the chunk scan, a and b, and one more [.., T/n, W] buffer
    return h.add_(a_cum.mul_(carry[..., None, :]))


def scan_bound(a: torch.Tensor, b: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(h, E)`` in float64 over dim -2 from h = 0: the recurrence and
    :func:`repro_torch.kernels.chunk_scan.rglru_tolerance`'s bound
    E_t = |a_t|·E_{t-1}·(1 + 2u) + u·(1 + u)·(|a_t·h_{t-1}| + |h_t|),
    both affine recurrences, each by a log-depth scan (the float64
    rounding of which is far below the f32 bound)."""
    u = 2.0 ** -24
    h = _affine_scan(a, b)
    h_prev = F.pad(h[..., :-1, :], (0, 0, 1, 0))
    e = _affine_scan(a.abs() * (1 + 2 * u),
                     u * (1 + u) * ((a * h_prev).abs() + h.abs()))
    return h, e


def sp_tolerance(a: torch.Tensor, b: torch.Tensor, n: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(h_exact, tol)`` in float64 for :func:`rglru_scan_sp` over ``n``
    equal chunks of the global ``a, b [..., T, W]``: the bound its f32
    evaluation meets when each chunk's scan meets
    :func:`repro_torch.kernels.chunk_scan.rglru_tolerance` (the kernel
    scans in time order).

    Per chunk c (exact A_c = Π a, H_c = the chunk's last state from 0,
    C_c = the exact state before the chunk) the computed carry departs
    from C_c by at most E_c = Σ_{j<c} W_jc·(e_j + |H_j|·γ_k), where W_jc
    = Π_{j<i<c} |A_i|, e_j bounds chunk j's last state, and γ_k (k =
    (c-j-1)·T/n + 2·⌈log2 n⌉ + 2, γ_k = k·u / (1 - k·u)) covers the
    rounded products of the A's and the rank scan's combines.  At t in
    chunk c (P_t the in-chunk product) the product term departs by at
    most D = P_t·(E_c + |C_c|·γ_{t+1}); the result is within e_t + D +
    u·(P_t·|C_c|·(1 + γ_{t+1}) + D) + u·(|h_t| + S), S the error before
    the sum."""
    f64 = torch.float64
    u = 2.0 ** -24
    t, w_ = a.shape[-2:]
    if t % n:
        raise ValueError(f"T = {t} does not split into {n} chunks")
    tc = t // n
    rounds = math.ceil(math.log2(n)) if n > 1 else 0

    def gamma(k):
        return k * u / (1 - k * u)

    a64, b64 = a.to(f64), b.to(f64)
    exact = _affine_scan(a64, b64)
    lead = a.shape[:-2]
    chunked = lead + (n, tc, w_)
    h_loc, e_loc = scan_bound(a64.reshape(chunked), b64.reshape(chunked))
    a_abs = a64.reshape(chunked).abs()
    prods = a_abs.prod(-2)                             # [.., n, W]
    last_h, last_e = h_loc[..., -1, :].abs(), e_loc[..., -1, :]
    ex = exact.reshape(chunked)
    g = torch.tensor([gamma(k + 1) for k in range(tc)], dtype=f64,
                     device=a.device)[:, None]
    p = a_abs.cumprod(-2)
    tol = torch.empty_like(ex)
    for c in range(n):
        e_c = torch.zeros_like(last_h[..., 0, :])
        w = torch.ones_like(e_c)
        for j in range(c - 1, -1, -1):
            e_c = e_c + w * (last_e[..., j, :] + last_h[..., j, :] * gamma(
                (c - j - 1) * tc + 2 * rounds + 2))
            w = w * prods[..., j, :]
        carry = ex[..., c - 1, -1, :].abs() if c else torch.zeros_like(e_c)
        pc = p[..., c, :, :]
        d = pc * (e_c[..., None, :] + carry[..., None, :] * g)
        before_sum = e_loc[..., c, :, :] + d + u * (
            pc * carry[..., None, :] * (1 + g) + d)
        tol[..., c, :, :] = before_sum + u * (ex[..., c, :, :].abs()
                                              + before_sum)
    return exact, tol.reshape(exact.shape)
