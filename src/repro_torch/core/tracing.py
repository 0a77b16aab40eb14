"""Traced-DAG frontend — write switch programs as plain Python functions.

The PyTorch counterpart of :mod:`repro.core.tracing`.  The paper's
toolchain starts from user source and recovers a dataflow
graph; here the user writes an ordinary function over symbolic
:class:`Value` handles and :func:`trace` records the graph directly:

    from repro_torch import core as acis

    def histogram_shuffle(hist, keys):
        h = acis.reduce(acis.map(torch.square, hist))
        k = acis.all_to_all(keys)
        return h, k

    prog = acis.trace(histogram_shuffle)          # -> DagProgram
    fn = engine.compile(prog, mesh, in_specs, out_specs)   # a LocalMesh

Every op below accepts and returns :class:`Value` handles and may only be
called on values of the trace in progress.  Multiple inputs and multiple
outputs are natural — no tuple hacks.  Node creation order is the DAG's
topological order.
"""

from __future__ import annotations

import builtins
import inspect
from typing import Callable, Optional, Union

import torch

from repro_torch.core.program import (Axis, DagNode, DagProgram, ErrorFeedback,
                                Node, OpKind)
from repro_torch.core.types import ADD, Monoid
from repro_torch.core.wire import WireCodec


class Value:
    """Symbolic handle to one tensor flowing through a traced program."""

    __slots__ = ("_tracer", "vid")

    def __init__(self, tracer: "_Tracer", vid: int):
        self._tracer = tracer
        self.vid = vid

    def __repr__(self):  # pragma: no cover
        return f"Value({self.vid})"


class _Tracer:
    def __init__(self, num_inputs: int):
        self.num_inputs = num_inputs
        self.nodes: list[DagNode] = []
        self._next_vid = num_inputs

    def emit(self, op: Node, inputs: tuple[Value, ...]) -> Value:
        for v in inputs:
            if not isinstance(v, Value):
                raise TypeError(
                    f"{op.kind.value} expects traced Values, got "
                    f"{type(v).__name__}; switch ops only run under trace()")
            if v._tracer is not self:
                raise ValueError(
                    f"{op.kind.value} received a Value from a different "
                    "trace — values cannot cross trace boundaries")
        out = self._next_vid
        self._next_vid += 1
        self.nodes.append(DagNode(op, tuple(v.vid for v in inputs), out))
        return Value(self, out)


_ACTIVE: list[_Tracer] = []


def _current(op_name: str) -> _Tracer:
    if not _ACTIVE:
        raise RuntimeError(
            f"acis.{op_name} called outside trace(); wrap the program in "
            "a function and pass it to trace() / engine.compile()")
    return _ACTIVE[-1]


def trace(fn: Callable, *, name: Optional[str] = None,
          num_inputs: Optional[int] = None) -> DagProgram:
    """Trace ``fn`` (a function of Value handles) into a :class:`DagProgram`.

    The program's input arity is the function's positional arity, not
    counting parameters with defaults (override with ``num_inputs`` for
    ``*args`` signatures); its outputs are whatever the function returns —
    a Value or a tuple/list of Values.
    """
    if num_inputs is None:
        sig = inspect.signature(fn)
        if any(p.kind == p.VAR_POSITIONAL for p in sig.parameters.values()):
            raise ValueError("pass num_inputs= for *args signatures")
        # parameters with defaults are configuration, not program inputs —
        # feeding them Values would smuggle symbols into e.g. `exclusive=`
        num_inputs = len([
            p for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.default is p.empty])
    if num_inputs < 1:
        raise ValueError("traced programs need at least one input")
    tracer = _Tracer(num_inputs)
    args = [Value(tracer, i) for i in range(num_inputs)]
    _ACTIVE.append(tracer)
    try:
        result = fn(*args)
    finally:
        _ACTIVE.pop()
    outs = result if isinstance(result, (tuple, builtins.list)) else (result,)
    for v in outs:
        if not isinstance(v, Value) or v._tracer is not tracer:
            raise TypeError(
                "traced function must return Value(s) from this trace, got "
                f"{type(v).__name__}")
    return DagProgram(num_inputs, tuple(tracer.nodes),
                      tuple(v.vid for v in outs),
                      name or getattr(fn, "__name__", "traced"))


# -- traced ops (the user-facing program vocabulary) -------------------------

def map(fn: Callable, *xs: Value, name: str = "",  # noqa: A001
        fusable: bool = True, elementwise: bool = False) -> Value:
    """Apply ``fn`` elementwise/locally; fusable into adjacent hops.

    ``fn`` must be *chunk-local* (elementwise or otherwise independent of
    how the tensor is split across ranks) unless ``fusable=False``: when
    the compiler fuses it into a collective's hop loop it runs once per
    in-flight chunk, so a function that mixes values across positions
    (e.g. ``cumsum``) would compute something different fused vs unfused.
    That is the IR's MAP contract, not a compiler quirk — use ``scan``
    for cross-rank ops, or mark the map ``fusable=False`` to keep it a
    standalone whole-payload stage.

    Accepts multiple inputs (``fn`` is called as ``fn(*tensors)``) — the
    only op that may, which is what lets one program combine tensors.

    ``elementwise=True`` is a stronger promise than chunk-locality: the
    body is strictly per-element (``fn(concat(xs)) == concat(fn(x) for
    x)``), which lets the Coalesce pass hoist the map off every bucketed
    leaf and run it once on the flat bucket instead.
    """
    if not xs:
        raise TypeError("map needs at least one input value")
    return _current("map").emit(
        Node(OpKind.MAP, fn=fn, fusable=fusable, elementwise=elementwise,
             name=name or getattr(fn, "__name__", "")), xs)


def _unary(op_name: str, op: Node, x: Value) -> Value:
    # always emit into the *active* trace — going through the Value's own
    # tracer would let a handle stashed from a finished trace silently
    # append nodes to a dead graph
    return _current(op_name).emit(op, (x,))


def reduce(x: Value, monoid: Monoid = ADD, *,  # noqa: A001
           axis: Axis = None) -> Value:
    """All-reduce over ``axis`` — ``None`` = the engine default axis,
    ``"auto"`` = every data-parallel axis of the compile topology (the
    LowerTopology pass then emits the hierarchical RS/AR/AG schedule)."""
    return _unary("reduce", Node(OpKind.REDUCE, monoid=monoid, axis=axis), x)


def reduce_scatter(x: Value, monoid: Monoid = ADD, *,
                   axis: Axis = None) -> Value:
    return _unary("reduce_scatter",
                  Node(OpKind.REDUCE_SCATTER, monoid=monoid, axis=axis), x)


def all_gather(x: Value, *, axis: Axis = None) -> Value:
    return _unary("all_gather", Node(OpKind.ALLGATHER, axis=axis), x)


def all_to_all(x: Value, *, axis: Axis = None) -> Value:
    return _unary("all_to_all", Node(OpKind.ALLTOALL, axis=axis), x)


def scan(x: Value, monoid: Monoid = ADD, *, exclusive: bool = False,
         axis: Axis = None) -> Value:
    return _unary("scan",
                  Node(OpKind.SCAN, monoid=monoid, exclusive=exclusive,
                       axis=axis), x)


def bcast(x: Value, root: int = 0, *, axis: Axis = None) -> Value:
    return _unary("bcast", Node(OpKind.BCAST, root=root, axis=axis), x)


def ef_reduce(x: Value, *, compressor: str = "int8",
              topk_ratio: float = 0.01,
              axis: Axis = None) -> tuple[Value, Value]:
    """Error-feedback compressed all-reduce (Type 3 look-aside).

    Returns ``(reduced, delivered)``: the lossily-reduced total, and what
    the lossy wire delivered of *this rank's* contribution — the caller
    forms the residual as ``target - delivered``.  The two values are
    sibling DAG nodes sharing one input; the compiler pairs them back into
    a single look-aside stage so the compression runs once.  If the
    program drops ``delivered``, DCE removes the sibling and only the
    reduction is emitted.
    """
    ef = ErrorFeedback(compressor=compressor, topk_ratio=topk_ratio)
    red = _unary("ef_reduce", Node(OpKind.REDUCE, ef=ef, axis=axis), x)
    dlv = _unary("ef_reduce", Node(OpKind.DELIVERED, ef=ef, axis=axis), x)
    return red, dlv


def _masked_renorm_fn(renormalize: bool) -> Callable:
    """Unpack the ``[size+1]`` masked-reduce buffer back to the payload
    shape, dividing by the live count when renormalizing.  ``orig`` is the
    pre-reduce value — the runtime shape donor, like the compiler's
    ``_unpad_like``."""

    def masked_renorm(packed, orig):
        n = packed.shape[-1] - 1
        body = packed[..., :n]
        if renormalize:
            cnt = torch.clamp_min(packed[..., n:n + 1], 1)
            body = body / cnt.to(body.dtype)
        return body.reshape(orig.shape)
    masked_renorm.masked_renormalize = renormalize
    return masked_renorm


def _masked_count_fn():
    def masked_count(packed):
        # clamped so a (transient) all-dead view cannot divide by zero
        n = packed.shape[-1] - 1
        cnt = packed[..., n:n + 1]
        return torch.clamp_min(cnt, 1).reshape(packed.shape[:-1])
    return masked_count


def masked_reduce(x: Value, alive: Value, monoid: Monoid = ADD, *,
                  axis: Axis = None,
                  renormalize: bool = True) -> tuple[Value, Value]:
    """Bounded-staleness all-reduce: ranks with ``alive == 0`` contribute
    the monoid identity, and the live count travels in the *same* flat
    ring buffer as the payload — one collective launch, not two.

    ``alive`` is this rank's liveness flag (scalar, nonzero = alive), a
    runtime input — changing the mask never retraces or recompiles.
    Returns ``(value, count)``: the masked reduction (renormalized by the
    live count when ``renormalize=True``, which requires the ``add``
    monoid — masked-mean semantics) and the clamped live count
    ``max(sum(alive), 1)``.  The count lane folds under the same monoid
    as the payload (it shares the ring), so for non-``add`` monoids it
    degrades to a clamped any-alive flag rather than a sum.  Drop
    ``count`` and DCE removes its node.

    The compiler expands this into a ``masked_pack`` map feeding a
    standard REDUCE over ``axis``, so it buckets in Coalesce, overlaps in
    the executor, and places on the CGRA like every other reduce.
    """
    if renormalize and monoid.name != "add":
        raise ValueError(
            "renormalize=True divides the total by the live count, which "
            f"is only meaningful for the add monoid, got {monoid.name!r}")
    t = _current("masked_reduce")
    packed = t.emit(
        Node(OpKind.MASKED_REDUCE, monoid=monoid, axis=axis), (x, alive))
    value = t.emit(
        Node(OpKind.MAP, fn=_masked_renorm_fn(renormalize),
             name="masked_renorm", fusable=False), (packed, x))
    count = t.emit(
        Node(OpKind.MAP, fn=_masked_count_fn(),
             name="masked_count", fusable=False), (packed,))
    return value, count


def wire(codec: WireCodec, x: Value) -> Value:
    """Declare the wire format for the collective this value feeds."""
    return _unary("wire", Node(OpKind.WIRE, codec=codec), x)
