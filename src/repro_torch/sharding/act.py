"""Activation sharding constraints (context-managed).

The port of :mod:`repro.sharding.act`.  The reference pins activation
shardings at block boundaries (the MaxText discipline) so that GSPMD's
global inference keeps weight all-gathers instead of activation-sized
all-reduces; model code calls :func:`shard_act` with logical dim names
and the active context maps them to mesh axes.

Eager rank-stacked tensors already carry their layout, so here
:func:`shard_act` never moves data.  Outside a context it returns its
input at once (serving and the acis step pay nothing).  Inside one it
computes the spec the reference would pin for a tensor of ``x``'s shape
— with the same divisibility rules: "tp" is dropped when the dim does
not divide the model axis (12 whisper heads on a 16-way axis), "dp" when
the batch does not divide the DP ranks — and records it on the context
(``ActCtx.records``), where the dry run reports it.  ``dims`` name the
*last* ``len(dims)`` dims of ``x``: rank dims in front are not named.
Under the GSPMD train step the named shape is a rank's local one.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from repro_torch.mesh import PartitionSpec as P

_CTX: contextvars.ContextVar[Optional["ActCtx"]] = \
    contextvars.ContextVar("repro_torch_act_sharding", default=None)


class ActCtx:
    def __init__(self, mesh, *, dp: bool = True, tp: bool = True,
                 parallelism: str = "fsdp_tp"):
        names = ("pod", "data", "model") if parallelism == "pure_dp" \
            else ("pod", "data")
        self.mesh = mesh
        self.dp_axes = tuple(a for a in names
                             if a in mesh.axis_names) if dp else ()
        self.tp_axis = "model" if tp and parallelism != "pure_dp" \
            and "model" in mesh.axis_names else None
        # (dims, shape, spec) of every pin made under this context
        self.records: list[tuple[tuple, tuple, P]] = []

    def spec(self, shape, dims) -> P:
        """The spec the reference pins for ``shape`` named by ``dims``."""
        spec = []
        for d, size in zip(dims, shape):
            if d == "dp" and self.dp_axes:
                total = 1
                for a in self.dp_axes:
                    total *= self.mesh.shape[a]
                spec.append(self.dp_axes if size % total == 0 and size > 1
                            else None)
            elif d == "tp" and self.tp_axis and \
                    size % self.mesh.shape[self.tp_axis] == 0:
                spec.append(self.tp_axis)
            else:
                spec.append(None)
        return P(*spec)

    def summary(self) -> dict:
        """Pins made, and how many named a "tp" dim the model axis could
        not take."""
        dropped = sum(1 for dims, _, spec in self.records
                      for d, s in zip(dims, spec) if d == "tp" and s is None)
        return {"pins": len(self.records), "tp_dropped": dropped}


def current() -> Optional[ActCtx]:
    return _CTX.get()


@contextlib.contextmanager
def activation_sharding(mesh, *, dp: bool = True, tp: bool = True,
                        parallelism: str = "fsdp_tp"):
    ctx = ActCtx(mesh, dp=dp, tp=tp, parallelism=parallelism)
    tok = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(tok)


def shard_act(x: torch.Tensor, *dims: Optional[str]) -> torch.Tensor:
    """``x`` as it is; ``dims`` name its last dims: "dp" | "tp" | None.

    Inside :func:`activation_sharding` the reference's spec for those
    dims is computed and recorded; no data moves."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    if len(dims) > x.dim():
        raise ValueError(f"shard_act: {len(dims)} names for a "
                         f"{x.dim()}-dim tensor {tuple(x.shape)}")
    shape = tuple(x.shape[x.dim() - len(dims):])
    ctx.records.append((tuple(dims), shape, ctx.spec(shape, dims)))
    return x
