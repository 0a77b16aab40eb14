"""Next-token cross-entropy (stable) + z-loss.

The port of :mod:`repro.train.loss`.  Leading dims before ``[B, T]``
are kept: under the port's train step they are the mesh's rank dims, and
every rank gets its own loss and metrics (the reference computes them
per shard inside ``shard_map``).
"""

from __future__ import annotations

from typing import Optional

import torch


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *,
                  z_loss: float = 1e-4,
                  mask: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, dict]:
    """logits: [..., B, T, V] (f32), targets: [..., B, T] integer.

    Returns (loss, {nll, z_loss, accuracy}), each of shape ``[...]``:
    the mean over ``[B, T]`` (masked tokens out when ``mask`` is given).
    ``accuracy`` takes the first index of a tied maximum, as ``jnp.argmax``.
    """
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)                          # [.., B, T]
    true_logit = torch.take_along_dim(
        logits, targets.to(torch.int64)[..., None], dim=-1)[..., 0]
    nll = lse - true_logit
    zl = z_loss * lse.square()
    per_tok = nll + zl
    bt = (-2, -1)
    # ``torch.argmax`` promises no order among ties: the first maximum is
    # the smallest index whose logit equals the row's max
    v = logits.shape[-1]
    idx = torch.arange(v, device=logits.device)
    first = torch.where(logits == logits.amax(-1, keepdim=True), idx,
                        v).amin(-1)
    hit = (first == targets).to(torch.float32)
    if mask is None:
        loss = per_tok.mean(bt)
        metrics = {"nll": nll.mean(bt), "z_loss": zl.mean(bt),
                   "accuracy": hit.mean(bt)}
    else:
        m = mask.to(torch.float32)
        denom = m.sum(bt).clamp_min(1.0)
        loss = (per_tok * m).sum(bt) / denom
        metrics = {"nll": (nll * mask).mean(bt),
                   "z_loss": (zl * mask).mean(bt),
                   "accuracy": (hit * mask).to(torch.float32).mean(bt)}
    return loss, metrics
