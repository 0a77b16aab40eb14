"""Native collectives over rank dims — what the partitioner inserts.

The reference's GSPMD step (``build_train_step_gspmd``) leaves every
collective to XLA's partitioner: weight all-gathers before use (FSDP),
the row-parallel all-reduce after ``wo`` (TP), reduce-scatters of the
gradients.  On a :class:`~repro_torch.mesh.LocalMesh` every rank is a
slice of one tensor ``[*rank, *local]``, so a collective is a gather,
a sum and a slice over rank dims — the ``xla`` backend's form, not an
ACiS ring: this step is the passive-network baseline ACiS is measured
against.

Each collective is a ``torch.autograd.Function`` whose backward is its
adjoint, so one backward leaves every shard its gradient:

  * :func:`all_gather` (a local dim gathered over axes, every rank the
    whole) ↔ reduce-scatter (the cotangents summed over those ranks,
    every rank its slice);
  * :func:`all_reduce` (a sum over axes, every rank the total) ↔
    all-reduce;
  * :func:`replicate` (identity: every rank uses its own copy of a
    replicated value) ↔ all-reduce (the copies' cotangents summed).

Both directions report their kind, axes and per-rank result bytes to the
active :class:`CollectiveLog` (``with counting() as log:``), which the
roofline reads as collective bytes.  Sums run in f32 (or wider) and round once
to the operand's dtype.  Results are views where they can be (a gathered
or reduced value is one tensor expanded over the ranks that share it).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional, Sequence

import torch

_LOG: contextvars.ContextVar[Optional["CollectiveLog"]] = \
    contextvars.ContextVar("repro_torch_native_log", default=None)


@dataclasses.dataclass(frozen=True)
class Entry:
    kind: str            # all-gather | reduce-scatter | all-reduce
    direction: str       # fwd | bwd
    axes: tuple
    bytes: int           # per rank, the result's
    in_shape: tuple      # one rank's operand
    out_shape: tuple     # one rank's result
    dtype: str


class CollectiveLog:
    """The collectives of a run, in issue order (:class:`Entry`).  With
    ``timed=True`` on CUDA tensors each collective is bracketed by CUDA
    events; :meth:`device_ms` sums them after a sync."""

    def __init__(self, timed: bool = False):
        self.entries: list[Entry] = []
        self.timed = timed
        self._events: list = []

    def add(self, e: Entry) -> None:
        self.entries.append(e)

    def bytes_by_kind(self) -> dict:
        out: dict = {}
        for e in self.entries:
            out[e.kind] = out.get(e.kind, 0) + e.bytes
        return dict(sorted(out.items()))

    def summary(self) -> dict:
        """Bytes and counts by kind and direction (per rank)."""
        out: dict = {}
        for e in self.entries:
            k = f"{e.kind}/{e.direction}"
            b, c = out.get(k, (0, 0))
            out[k] = (b + e.bytes, c + 1)
        return {k: {"bytes": b, "count": c}
                for k, (b, c) in sorted(out.items())}

    @property
    def total_bytes(self) -> int:
        return sum(e.bytes for e in self.entries)

    def device_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self._events)

    @contextlib.contextmanager
    def span(self, x: torch.Tensor):
        if not (self.timed and x.device.type == "cuda"):
            yield
            return
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        self._events.append((a, b))


@contextlib.contextmanager
def counting(log: Optional[CollectiveLog] = None, *, timed: bool = False):
    """Record the collectives issued inside the block into ``log`` (a
    fresh one by default, yielded)."""
    log = CollectiveLog(timed=timed) if log is None else log
    tok = _LOG.set(log)
    try:
        yield log
    finally:
        _LOG.reset(tok)


def _record(kind: str, direction: str, axes, x_in: torch.Tensor,
            out: torch.Tensor, nd: int, log=None) -> None:
    log = _LOG.get() if log is None else log
    if log is None:
        return
    shape = tuple(out.shape[nd:])
    log.add(Entry(kind, direction, tuple(axes),
                  math.prod(shape) * out.element_size(),
                  tuple(x_in.shape[nd:]), shape, str(out.dtype)))


def note(kind: str, direction: str, axes, shape, dtype) -> None:
    """Log a collective one rank's program would issue, without running
    it (the dry run's per-rank serving programs)."""
    log = _LOG.get()
    if log is None:
        return
    shape = tuple(shape)
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    log.add(Entry(kind, direction, tuple(axes), nbytes, shape, shape,
                  str(dtype)))


def _span(x, log=None):
    log = _LOG.get() if log is None else log
    return log.span(x) if log is not None else contextlib.nullcontext()


def _rank_dims(mesh, axes: Sequence[str]) -> list[int]:
    return [mesh.dim(a) for a in axes]


def _sum_over(x: torch.Tensor, dims: list[int]) -> torch.Tensor:
    """Sum over rank ``dims`` in f32 (keepdim), rounded once, expanded
    back over them: every rank holds the total."""
    if not dims:
        return x
    acc = torch.promote_types(x.dtype, torch.float32) \
        if x.is_floating_point() else x.dtype
    return x.to(acc).sum(dims, keepdim=True).to(x.dtype).expand(x.shape)


def _gather(x: torch.Tensor, mesh, axes: Sequence[str],
            dim: int) -> torch.Tensor:
    """Local dim ``dim`` of ``x`` gathered over ``axes`` (major first),
    every rank of those axes holding the whole (an expanded view)."""
    nd = mesh.rank_ndim
    for a in reversed(tuple(axes)):      # minor axis first
        r = mesh.dim(a)
        n = x.shape[r]
        if n == 1:                       # an axis of size 1 gathers nothing
            continue
        y = x.movedim(r, nd - 1 + dim)   # the rank dim just before `dim`
        y = y.reshape(y.shape[:nd - 1 + dim] + (-1,)
                      + y.shape[nd + dim + 1:])
        x = y.unsqueeze(r).expand(y.shape[:r] + (n,) + y.shape[r:])
    return x


def _scatter(g: torch.Tensor, mesh, axes: Sequence[str],
             dim: int) -> torch.Tensor:
    """The adjoint of :func:`_gather`: cotangents summed over ``axes``'
    ranks, each rank keeping its slice of local dim ``dim``."""
    nd = mesh.rank_ndim
    dims = _rank_dims(mesh, axes)
    g = _sum_over(g, dims)
    for a in tuple(axes):                # major axis first
        r = mesh.dim(a)
        n = mesh.axis_size(a)
        if n == 1:
            continue
        y = g.select(r, 0)               # every rank holds the total
        full = y.shape[nd - 1 + dim]
        y = y.reshape(y.shape[:nd - 1 + dim] + (n, full // n)
                      + y.shape[nd + dim:])
        g = y.movedim(nd - 1 + dim, r)
    return g.contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        # the backward may run on autograd's device thread, where the
        # context variable is unset: it reports to the forward's log
        ctx.mesh, ctx.axes, ctx.dim, ctx.log = mesh, axes, dim, _LOG.get()
        with _span(x):
            y = _gather(x, mesh, axes, dim)
        _record("all-gather", "fwd", axes, x, y, mesh.rank_ndim)
        return y

    @staticmethod
    def backward(ctx, g):
        with _span(g, ctx.log):
            out = _scatter(g, ctx.mesh, ctx.axes, ctx.dim)
        _record("reduce-scatter", "bwd", ctx.axes, g, out,
                ctx.mesh.rank_ndim, ctx.log)
        return out, None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes, ctx.log = mesh, axes, _LOG.get()
        with _span(x):
            y = _sum_over(x, _rank_dims(mesh, axes))
        _record("all-reduce", "fwd", axes, x, y, mesh.rank_ndim)
        return y

    @staticmethod
    def backward(ctx, g):
        with _span(g, ctx.log):
            out = _sum_over(g, _rank_dims(ctx.mesh, ctx.axes))
        _record("all-reduce", "bwd", ctx.axes, g, out, ctx.mesh.rank_ndim,
                ctx.log)
        return out, None, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes, ctx.log = mesh, axes, _LOG.get()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with _span(g, ctx.log):
            out = _sum_over(g, _rank_dims(ctx.mesh, ctx.axes))
        _record("all-reduce", "bwd", ctx.axes, g, out, ctx.mesh.rank_ndim,
                ctx.log)
        return out, None, None


def all_gather(x: torch.Tensor, mesh, axes: Sequence[str],
               dim: int) -> torch.Tensor:
    """Gather local dim ``dim`` of rank-stacked ``x`` over ``axes``."""
    axes = tuple(axes)
    if not axes:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(x, mesh, axes, dim)
    with _span(x):
        y = _gather(x, mesh, axes, dim)
    _record("all-gather", "fwd", axes, x, y, mesh.rank_ndim)
    return y


def all_reduce(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum rank-stacked ``x`` over ``axes``; every rank holds the total."""
    axes = tuple(axes)
    if not axes:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduce.apply(x, mesh, axes)
    with _span(x):
        y = _sum_over(x, _rank_dims(mesh, axes))
    _record("all-reduce", "fwd", axes, x, y, mesh.rank_ndim)
    return y


def all_mean(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The mean over ``axes``' ranks (an all-reduce, then a scale)."""
    n = math.prod(mesh.axis_size(a) for a in axes)
    return all_reduce(x, mesh, axes) / n if n > 1 else x


def replicate(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """``x`` as it is; in the backward, the copies' cotangents over
    ``axes`` are summed (an all-reduce)."""
    axes = tuple(axes)
    if not axes or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Replicate.apply(x, mesh, axes)


def take_slice(x: torch.Tensor, mesh, axes: Sequence[str],
               dim: int) -> torch.Tensor:
    """Each rank keeps its slice of local dim ``dim`` split over ``axes``
    (major first): a local slice, no data moves between ranks."""
    nd = mesh.rank_ndim
    x = x.expand(mesh.rank_shape + tuple(x.shape[nd:]))
    for a in tuple(axes):                # major axis first
        r = mesh.dim(a)
        n = mesh.axis_size(a)
        if n == 1:
            continue
        full = x.shape[nd + dim]
        y = x.reshape(x.shape[:nd + dim] + (n, full // n)
                      + x.shape[nd + dim + 1:]).movedim(nd + dim, nd)
        grid = mesh.axis_index(a).to(x.device)
        idx = grid.reshape(grid.shape + (1,) * (y.dim() - nd)).expand(
            y.shape[:nd] + (1,) + y.shape[nd + 1:])
        x = torch.gather(y, nd, idx).squeeze(nd)
    return x
