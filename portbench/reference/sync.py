"""The reference of a gradient sync: every rank ends with the mean over
the ranks of their gradients.

``mean_over_ranks`` computes it in float32 from the rank-stacked inputs.
``fp8_ring_mean`` is the control: the same mean computed in the next
precision below bfloat16, float8 e4m3, as a ring would: each rank's
input rounded to e4m3 and every partial sum rounded again, under one
scale for the leaf that keeps the whole sum inside the format.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """x [n, *shape] -> the float32 mean over the leading rank dim."""
    return x.float().mean(0)


def fp8_ring_mean(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    xf = x.float()
    s = (xf.abs().amax() * n).clamp_min(1e-30) / E4M3_MAX

    def q(y):
        return (y / s).to(torch.float8_e4m3fn).float() * s

    acc = q(xf[0])
    for r in range(1, n):
        acc = q(acc + q(xf[r]))
    return acc / n


def widest_gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest distance of any rank's element of ``out`` [n, *shape]
    from ``ref`` [*shape], over the largest magnitude of ``ref``."""
    scale = ref.abs().amax().clamp_min(1e-30)
    return float((out.float() - ref).abs().amax() / scale)
