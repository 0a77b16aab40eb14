"""Optimizers (from scratch): AdamW and Adafactor, plus LR schedules.

The port of :mod:`repro.train.optimizer`: functional ``(init, update)``
pairs over the port's pytrees (nested dicts of tensors), in the
reference's order of operations (AdamW: ``m / c1``, then ``sqrt(v / c2)
+ eps``, weight decay inside ``delta``; the new param cast to the param
dtype and the moments to ``state_dtype``).  ``update`` runs under
``torch.no_grad`` and returns new tensors; ``step`` is a 0-dim integer
tensor (or an int) and every scalar of the schedule is computed in f32
on the params' device, as the reference computes it on its device.
Adafactor's factored statistics run over the last two dims of each leaf,
so a stacked ``[n_periods, ...]`` leaf keeps its stack.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch import tree

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, Any], tuple[PyTree, PyTree]]
    name: str = "opt"


def _f32_step(step, device) -> torch.Tensor:
    return torch.as_tensor(step, device=device).to(torch.float32)


def _device(params: PyTree) -> torch.device:
    leaves = tree.tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def warmup_cosine(base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``final_frac * base_lr`` at ``total``; f32 throughout."""
    def lr(step):
        step = _f32_step(step, getattr(step, "device", "cpu"))
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def _lr_fn(lr):
    if callable(lr):
        return lr
    return lambda step: torch.tensor(
        lr, dtype=torch.float32, device=getattr(step, "device", "cpu"))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr: Callable | float = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          state_dtype=torch.float32) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        return {"m": tree.tree_map(zeros, params),
                "v": tree.tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step, reducers=None):
        # elementwise: a sharded leaf updates as it is (``reducers``,
        # Adafactor's cross-shard means, are not needed)
        step = torch.as_tensor(step, device=_device(params))
        t = step.to(torch.float32) + 1.0
        lr_t = lr_fn(step)
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t

        def upd(g, m, v, p):
            g = g.to(torch.float32)
            pf = p.to(torch.float32)
            m = b1 * m.to(torch.float32) + (1 - b1) * g
            v = b2 * v.to(torch.float32) + (1 - b2) * g.square()
            mh, vh = m / c1, v / c2
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * pf
            new_p = pf - lr_t * delta
            return new_p.to(p.dtype), m.to(state_dtype), v.to(state_dtype)

        g_leaves, td = tree.tree_flatten(grads)
        out = [upd(*xs) for xs in zip(g_leaves, tree.tree_leaves(state["m"]),
                                      tree.tree_leaves(state["v"]),
                                      tree.tree_leaves(params))]

        def rebuild(i):
            return tree.tree_unflatten(td, [o[i] for o in out])
        return rebuild(0), {"m": rebuild(1), "v": rebuild(2)}

    return Optimizer(init, update, "adamw")


def _collect(node, d, out: list) -> None:
    # a module function, not a recursive closure over ``out``: that would
    # be a reference cycle keeping the found tensors alive (as in
    # ``repro_torch.tree``)
    if d == "*":
        out.append(node)
        return
    (kind, meta), kids = d
    if kind == "dict":
        for key, sub in zip(meta, kids):
            _collect(node[key], sub, out)
    elif kind in ("list", "tuple"):
        for x, sub in zip(node, kids):
            _collect(x, sub, out)


def _leaves_at(t: PyTree, td) -> list:
    """The nodes of ``t`` found where ``td`` has its leaves."""
    out: list = []
    _collect(t, td, out)
    return out


class LocalMeans:
    """The means Adafactor takes of a whole (unsharded) leaf.  A sharded
    leaf's reducer (:class:`repro_torch.train.step.ShardMeans`) also
    averages over the ranks that split the reduced dim, so the update
    equals the global one."""

    rank_ndim = 0

    def mean(self, x: torch.Tensor, dim: int, pdim: int,
             keepdim: bool = False) -> torch.Tensor:
        """The mean over ``x``'s dim ``dim``, which is the param's dim
        ``pdim``."""
        return x.mean(dim, keepdim=keepdim)

    def mean_all(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean()


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; memory-lean for 100B+ params)
# ---------------------------------------------------------------------------

def adafactor(lr: Callable | float = 1e-2, decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def per(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"f": tree.tree_map(per, params)}

    @torch.no_grad()
    def update(grads, state, params, step, reducers=None):
        """``reducers``: one :class:`LocalMeans`-like object a leaf (flatten
        order) for rank-stacked shards; whole leaves by default."""
        step = torch.as_tensor(step, device=_device(params))
        t = step.to(torch.float32) + 1.0
        beta = 1.0 - t ** (-decay)
        lr_t = lr_fn(step)

        def upd(g, st, p, red):
            g = g.to(torch.float32)
            g2 = g.square() + eps
            if _factored(p.shape[red.rank_ndim:]):
                vr = beta * st["vr"] + (1 - beta) * red.mean(g2, -1, -1)
                vc = beta * st["vc"] + (1 - beta) * red.mean(g2, -2, -2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp_min(
                             red.mean(vr, -1, -2, keepdim=True)[..., None],
                             eps))
                pre = g * torch.rsqrt(denom + eps)
                new_st = {"vr": vr, "vc": vc}
            else:
                v = beta * st["v"] + (1 - beta) * g2
                pre = g * torch.rsqrt(v + eps)
                new_st = {"v": v}
            # update clipping (RMS)
            rms = torch.sqrt(red.mean_all(pre.square()) + 1e-12)
            pre = pre / torch.clamp_min(rms / clip_threshold, 1.0)
            pf = p.to(torch.float32)
            new_p = pf - lr_t * (pre + weight_decay * pf)
            return new_p.to(p.dtype), new_st

        g_leaves, td = tree.tree_flatten(grads)
        st_leaves = _leaves_at(state["f"], td)
        p_leaves = tree.tree_leaves(params)
        reds = reducers or [LocalMeans()] * len(g_leaves)
        out = [upd(g, s, p, r) for g, s, p, r in zip(g_leaves, st_leaves,
                                                      p_leaves, reds)]
        return (tree.tree_unflatten(td, [o[0] for o in out]),
                {"f": tree.tree_unflatten(td, [o[1] for o in out])})

    return Optimizer(init, update, "adafactor")


def make_optimizer(name: str, lr=None, total_steps: int = 10000) -> Optimizer:
    if name == "adamw":
        return adamw(lr or warmup_cosine(3e-4, 200, total_steps))
    if name == "adafactor":
        return adafactor(lr or warmup_cosine(1e-2, 200, total_steps))
    raise ValueError(f"unknown optimizer {name!r}")
