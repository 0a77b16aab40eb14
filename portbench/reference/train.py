"""The reference's first training steps, written from the job's
definition: data-parallel ranks, each rank's gradient of its mean loss,
the exchange (the mean over the ranks), error feedback where the job's
sync is compressed, and AdamW.

Everything is float32 (products without TF32) except what the
configuration stores: parameters are kept in ``param_dtype`` between
steps, as the configuration states.  A compressed sync follows the
int8 error-feedback rule: rank ``r`` sends its target ``t = g + e``
quantized to int8 in blocks of 256 (scale ``absmax / 127`` a block,
rounding half to even), the ranks' decoded contributions are averaged,
and ``e = t - decoded`` is kept for the next step.  Rows are processed a
rank at a time, so the reference fits beside nothing else.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from portbench.reference.model import float32_matmuls, matmul, row_losses

QBLOCK = 256


def int8_roundtrip(t: torch.Tensor, block: int = QBLOCK) -> torch.Tensor:
    """``t`` (float32) quantized to int8 in blocks of ``block`` elements of
    its flattened form and decoded again."""
    flat = t.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block)
    absmax = blocks.abs().amax(-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(blocks / scale), -127, 127)
    return (q * scale).reshape(-1)[:t.numel()].reshape(t.shape)


def _norms(tensors: dict) -> dict:
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[k].float())
                        for k in names]).tolist()
    return dict(zip(names, vals))


def reference_steps(cfg: dict, job: dict, weights: dict, batches: list, *,
                    precision: str = "float32",
                    per_rank: Optional[Callable] = None) -> dict:
    """Runs ``len(batches)`` steps from ``weights`` (path -> tensor in
    ``param_dtype``; not modified).  ``batches``: ``{"tokens": [B, T+1],
    "context": [B, Te, d] or None}``, the global batch, rank ``r`` taking
    rows ``r*B/n .. (r+1)*B/n``.  Returns the readings the comparison
    uses: ``loss`` (each step's mean loss over the ranks), ``first_grad``
    and ``grad_norms`` (the first step's exchanged gradient and each
    leaf's norm of it),
    ``update_norms`` (each leaf's norm of the parameters' change over
    all steps) and, with error feedback, ``residual_norms`` (each rank's
    norm of its whole residual after the first step).  ``per_rank(r,
    grads)`` is called with each rank's own gradient of the first step
    (path -> float32 tensor), before the exchange."""
    n = job["ranks"]
    opt = job["optimizer"]
    ef = job.get("ef_compressor")
    mm = matmul(precision)
    P = {k: w.detach().clone() for k, w in weights.items()}
    m = {k: torch.zeros(w.shape, dtype=torch.float32, device=w.device)
         for k, w in P.items()}
    v = {k: torch.zeros_like(x) for k, x in m.items()}
    res = [{k: torch.zeros_like(x) for k, x in m.items()}
           for _ in range(n)] if ef else None
    out: dict = {"loss": []}
    with float32_matmuls():
        for s, batch in enumerate(batches):
            tokens, ctx = batch["tokens"], batch.get("context")
            b = tokens.shape[0] // n
            W = {k: p.float().requires_grad_() for k, p in P.items()}
            names = list(W)
            gsum = {k: torch.zeros_like(x) for k, x in m.items()}
            loss = 0.0
            for r in range(n):
                rows = slice(r * b, (r + 1) * b)
                c = None if ctx is None else ctx[rows].float()
                lr_ = row_losses(W, cfg, tokens[rows], c, mm).mean()
                grads = torch.autograd.grad(lr_, [W[k] for k in names])
                loss = loss + lr_.detach()
                if s == 0 and per_rank is not None:
                    per_rank(r, dict(zip(names, grads)))
                for k, g in zip(names, grads):
                    if ef:
                        t = g + res[r][k]
                        d = int8_roundtrip(t)
                        res[r][k] = t - d
                        g = d
                    gsum[k] += g
                del grads
            gmean = {k: x / n for k, x in gsum.items()}
            out["loss"].append(float(loss / n))
            if s == 0:
                out["grad_norms"] = _norms(gmean)
                out["first_grad"] = gmean
                if ef:
                    out["residual_norms"] = [
                        float(torch.sqrt(sum(
                            torch.linalg.vector_norm(res[r][k]).square()
                            for k in names))) for r in range(n)]
            t = s + 1
            c1 = 1.0 - opt["b1"] ** t
            c2 = 1.0 - opt["b2"] ** t
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
    out["update_norms"] = _norms({k: P[k].float() - weights[k].float()
                                  for k in P})
    return out
