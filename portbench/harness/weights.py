"""The benchmark's weights and gradients, drawn on the device from the
seed in a few large calls, in the dtypes the configuration stores.

The same call with the same seed gives the same values, so the
reference draws its own copy after the program's state is freed.
:func:`nest` builds the program's nested tree from the flat dict and
holds it against the program's own layout.
"""

from __future__ import annotations

import math

import torch

from portbench.harness.seeds import generator
from portbench.reference.spec import Leaf


def draw(spec: list[Leaf], seed: int, device) -> dict:
    """path -> tensor: the normal leaves from one float32 draw (scaled
    and cast leaf by leaf), norm scales ones and biases zeros."""
    normal = [x for x in spec if x.init[0] == "normal"]
    flat = torch.randn(sum(math.prod(x.shape) for x in normal),
                       generator=generator(device, seed, "weights"),
                       dtype=torch.float32, device=device)
    out, off = {}, 0
    for x in spec:
        if x.init[0] == "normal":
            n = math.prod(x.shape)
            out[x.path] = (flat[off:off + n].view(x.shape)
                           * x.init[1]).to(x.dtype)
            off += n
        elif x.init[0] == "ones":
            out[x.path] = torch.ones(x.shape, dtype=x.dtype, device=device)
        else:
            out[x.path] = torch.zeros(x.shape, dtype=x.dtype, device=device)
    return out


def draw_grads(spec: list[Leaf], ranks: int, seed: int, index: int,
               device, std: float) -> dict:
    """path -> a rank-stacked gradient ``[ranks, *shape]`` in the leaf's
    dtype: normal draws times ``std``, one draw per dtype.  ``index``
    names one input of a pool."""
    out = {}
    for dt in sorted({x.dtype for x in spec}, key=str):
        group = [x for x in spec if x.dtype == dt]
        flat = torch.randn(ranks * sum(math.prod(x.shape) for x in group),
                           generator=generator(device, seed, "grads", index,
                                               str(dt)),
                           dtype=dt, device=device).mul_(std)
        off = 0
        for x in group:
            n = ranks * math.prod(x.shape)
            out[x.path] = flat[off:off + n].view((ranks,) + x.shape)
            off += n
    return out


def paths_of(tree, prefix: str = "") -> dict:
    """path -> leaf of a nested dict of tensors (keys joined by dots)."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(paths_of(v, p))
        else:
            out[p] = v
    return out


def nest(flat: dict, layout: dict) -> dict:
    """The nested dict of ``layout`` (a program's tree, e.g. of meta
    tensors; empty sub-dicts kept) filled from ``flat``.  Raises when
    the layout's leaves differ from ``flat``'s in paths, shapes or
    dtypes (ignoring leading dims ``flat`` has beyond the layout's)."""
    want = paths_of(layout)
    if set(want) != set(flat):
        raise ValueError("the program's parameter layout differs from the "
                         f"benchmark's: only in the program "
                         f"{sorted(set(want) - set(flat))}, only in the "
                         f"benchmark {sorted(set(flat) - set(want))}")
    for p, m in want.items():
        x = flat[p]
        if tuple(x.shape[x.dim() - m.dim():]) != tuple(m.shape) \
                or x.dtype != m.dtype:
            raise ValueError(f"{p}: the program has {tuple(m.shape)} "
                             f"{m.dtype}, the benchmark {tuple(x.shape)} "
                             f"{x.dtype}")

    def build(node, prefix):
        return {k: build(v, f"{prefix}.{k}" if prefix else str(k))
                if isinstance(v, dict)
                else flat[f"{prefix}.{k}" if prefix else str(k)]
                for k, v in node.items()}
    return build(layout, "")
