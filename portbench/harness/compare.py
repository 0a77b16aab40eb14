"""The comparison that decides ``correct``: the numbers compared and how
each is held to its limit.

Training (readings of the program and of the reference, as
``reference/train.py`` returns them):

  * ``loss_gap``: the largest relative gap of a checked step's loss;
  * ``grad_gap``: the first step's gradient as the optimizer gets it,
    by the worst leaf: the gap between the two norms of the leaf over
    the reference's norm of that leaf or of the median leaf, whichever
    is larger;
  * ``grad_diff``: the first step's gradient again, by the worst leaf:
    the norm of the difference of the two gradients over the same
    denominator.  The gaps of norms and of losses average rounding
    errors away, so a forward in float8 reads close to the program's
    bfloat16 in them; the difference does not;
  * ``rank_grad_diff``: every rank's own gradient of the first step,
    before the exchange, by the worst rank and leaf: the norm of the
    difference over the reference's norm of that rank's leaf or of that
    rank's median leaf, whichever is larger (:class:`RankGradDiff`).  A
    fault in one rank's gradient is diluted by the rank count in the
    exchanged mean; here it is not;
  * ``update_gap``: the same for the parameters' change over the
    checked steps, leaving out leaves whose reference gradient norm is
    under a thousandth of the median leaf's (Adam moves those by
    round-off alone);
  * ``residual_gap``: with error feedback, the relative gap of the norm
    of a rank's whole residual (every leaf) after the first step, by the
    worst rank.  Whole, not by leaf: the compressor quantizes blocks of
    the program's bucket layout, where a block may hold the tails of two
    small leaves, so a small leaf's residual depends on that layout and
    the reference (blocks of each leaf) cannot follow it.

A gradient sync: ``sync_gap``, the widest gap of any rank's element
from the float32 mean over the largest magnitude of that mean, by the
worst leaf and sampled call (``reference/sync.py``).

A number that is not finite fails.
"""

from __future__ import annotations

import math
import statistics

import torch

MOVED = 1e-3


def norm_gaps(got: dict, want: dict, keep=None) -> dict:
    """leaf -> the gap of its two norms over the reference's norm of the
    leaf or of the median leaf, whichever is larger."""
    names = [k for k in want if keep is None or k in keep]
    med = statistics.median(want[k] for k in names)
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in names}


def norm_gap(got: dict, want: dict, keep=None) -> float:
    return max(norm_gaps(got, want, keep).values())


def diff_gap(got: dict, want: dict, norms: dict) -> float:
    """The worst leaf's norm of ``got - want`` over the norm of ``want``
    (``norms``) of the leaf or of the median leaf, whichever is larger."""
    med = statistics.median(norms.values())
    return max(float(torch.linalg.vector_norm(
        got[k].to(want[k].device).float() - want[k].float()))
        / max(norms[k], med, 1e-30) for k in want)


def moved(ref: dict) -> set:
    """The leaves whose reference gradient norm reaches a thousandth of
    the median leaf's."""
    gn = ref["grad_norms"]
    med = statistics.median(gn.values())
    return {k for k, v in gn.items() if v >= MOVED * med}


class RankGradDiff:
    """``rank_grad_diff`` of one set of readings: the reference calls it
    with each rank's own gradient of the first step (``r``, path ->
    float32 tensor); ``rank_grads`` holds the readings' (one dict a
    rank, path -> tensor, any device)."""

    def __init__(self, rank_grads: list):
        self.rank_grads = rank_grads
        self.value = 0.0 if rank_grads else math.inf

    def __call__(self, r: int, grads: dict) -> None:
        if not self.rank_grads:
            return
        got = self.rank_grads[r]
        if set(got) != set(grads):
            self.value = math.inf
            return
        norms = {k: float(torch.linalg.vector_norm(g))
                 for k, g in grads.items()}
        self.value = max(self.value, diff_gap(got, grads, norms))


def train_numbers(prog: dict, ref: dict, rank_diff: RankGradDiff) -> dict:
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    out = {"loss_gap": max(gaps),
           "grad_gap": norm_gap(prog["grad_norms"], ref["grad_norms"]),
           "grad_diff": diff_gap(prog["first_grad"], ref["first_grad"],
                                 ref["grad_norms"]),
           "rank_grad_diff": rank_diff.value,
           "update_gap": norm_gap(prog["update_norms"], ref["update_norms"],
                                  moved(ref))}
    if "residual_norms" in ref:
        a, b = prog.get("residual_norms", []), ref["residual_norms"]
        out["residual_gap"] = max(abs(x - y) / y for x, y in zip(a, b)) \
            if len(a) == len(b) else math.inf
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number finite and within its limit, {name: {value, limit}})
    over the limits' names; a number missing from ``numbers`` fails."""
    table = {k: {"value": numbers.get(k, math.nan), "limit": lim}
             for k, lim in limits.items()}
    ok = all(math.isfinite(r["value"]) and r["value"] <= r["limit"]
             for r in table.values())
    return ok, table
