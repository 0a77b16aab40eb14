"""SwitchProgram IR — the ACiS software-support analogue.

The PyTorch counterpart of :mod:`repro.core.program`; the IR itself is
framework-free and identical.  The paper's toolchain (§VI.B): parse MPI
source → LLVM IR → dataflow graph → schedule/register-allocate onto the
CGRA → binary carried as an argument of the fused-collective routine.

The IR here is a true dataflow **DAG** (:class:`DagProgram`): nodes with
explicit inputs and outputs over numbered values, multiple program inputs
and multiple program outputs.  Users normally do not build it by hand —
they write a plain Python function over symbolic values and call
:func:`repro_torch.core.tracing.trace`; the compiler (core/compiler.py)
runs a pass pipeline (Legalize → LowerTopology → Coalesce → FuseHops →
SelectSchedule → Emit) over the DAG and emits one rank-local program that
runs eagerly over the active mesh.

:class:`SwitchProgram` — the original linear chain-of-nodes spelling — is
kept as a thin front-end shim; :meth:`SwitchProgram.to_dag` builds the
degenerate single-input chain DAG.

Node vocabulary (the "SPU instruction set" at graph granularity):
  MAP(fn)              — elementwise/user map, fusable into adjacent hops
  REDUCE(monoid)       — all-reduce (``ef`` set: error-feedback compressed)
  REDUCE_SCATTER(m)    — reduce-scatter
  ALLGATHER            — all-gather
  ALLTOALL             — all-to-all
  SCAN(monoid)         — cross-rank prefix scan (Type 3)
  BCAST(root)          — broadcast
  WIRE(codec)          — wire-format change for downstream links (Type 0/2)
  DELIVERED            — what the lossy wire delivered of *this rank's*
                         contribution (the error-feedback sibling of an
                         ``ef`` REDUCE; pairs into one look-aside stage)
  MASKED_REDUCE(m)     — bounded-staleness all-reduce of ``(x, alive)``:
                         ranks whose alive flag is 0 contribute the monoid
                         identity, and the live count rides in the *same*
                         flat buffer as the payload (one ring, not two).
                         Legalize expands it to masked_pack → REDUCE, so
                         downstream passes bucket/overlap/place it like
                         any other reduce.

Every collective op additionally carries an ``axis``: ``None`` means "the
engine's default axis", ``"auto"`` means "all data-parallel axes of the
compile topology", a string names one mesh axis, and a tuple names a
compound axis (innermost first).  Compound/auto axes are resolved by the
compiler's LowerTopology pass — see :mod:`repro_torch.core.compiler`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional, Sequence, Union

from repro_torch.core.types import ADD, Monoid
from repro_torch.core.wire import IDENTITY, WireCodec


class OpKind(enum.Enum):
    MAP = "map"
    REDUCE = "reduce"
    REDUCE_SCATTER = "reduce_scatter"
    ALLGATHER = "allgather"
    ALLTOALL = "alltoall"
    SCAN = "scan"
    BCAST = "bcast"
    WIRE = "wire"
    DELIVERED = "delivered"
    MASKED_REDUCE = "masked_reduce"


COLLECTIVE_KINDS = {
    OpKind.REDUCE, OpKind.REDUCE_SCATTER, OpKind.ALLGATHER,
    OpKind.ALLTOALL, OpKind.SCAN, OpKind.BCAST, OpKind.DELIVERED,
    OpKind.MASKED_REDUCE,
}

# axis field: None (engine default), "auto" (all DP axes of the topology),
# one mesh-axis name, or a tuple of names (compound axis, innermost first)
Axis = Union[None, str, tuple]

AUTO_AXIS = "auto"


@dataclasses.dataclass(frozen=True)
class ErrorFeedback:
    """Error-feedback compression spec riding on a REDUCE/DELIVERED pair.

    ``compressor`` selects the Type 3 look-aside implementation
    (lowered by ``core/lookaside.py``, a later slice of the port).
    """

    compressor: str = "int8"
    topk_ratio: float = 0.01


@dataclasses.dataclass(frozen=True)
class Node:
    kind: OpKind
    fn: Optional[Callable] = None          # MAP payload
    monoid: Monoid = ADD                   # REDUCE/RS/SCAN payload
    codec: WireCodec = IDENTITY            # WIRE payload
    root: int = 0                          # BCAST payload
    exclusive: bool = False                # SCAN payload
    axis: Axis = None                      # collective axis (see module doc)
    ef: Optional[ErrorFeedback] = None     # REDUCE/DELIVERED payload
    fusable: bool = True                   # MAP: may be hop-fused (must be
    #                                        chunk-local; shape transforms
    #                                        such as the compiler's pad/unpad
    #                                        bookkeeping maps are not)
    elementwise: bool = False              # MAP: fn is strictly per-element
    #                                        (f(concat(xs)) == concat(f(x))),
    #                                        so Coalesce may hoist it from
    #                                        per-leaf split outputs onto the
    #                                        flat bucket — a caller promise,
    #                                        declared at trace time
    name: str = ""

    def label(self) -> str:
        base = self.kind.value
        if self.kind == OpKind.MAP and self.name:
            base = f"map:{self.name}"
        elif self.kind in (OpKind.REDUCE, OpKind.REDUCE_SCATTER, OpKind.SCAN,
                           OpKind.MASKED_REDUCE):
            base = f"{base}:{self.monoid.name}"
            if self.ef is not None:
                base += f"+ef[{self.ef.compressor}]"
        elif self.kind == OpKind.WIRE:
            base = f"wire:{self.codec.name}"
        elif self.kind == OpKind.DELIVERED and self.ef is not None:
            base = f"delivered[{self.ef.compressor}]"
        if self.axis is not None and self.kind not in (OpKind.MAP,
                                                       OpKind.WIRE):
            base += f"@{self.axis}"
        return base


# -- user-facing constructors ------------------------------------------------

def Map(fn: Callable, name: str = "", fusable: bool = True,
        elementwise: bool = False) -> Node:
    """``fusable=False`` marks a map whose body is *not* chunk-local
    (e.g. a cumsum or other cross-position transform): the compiler will
    never hop-fuse it into a collective's chunk loop, and the CGRA
    mapper still places it as a whole-payload pipeline stage.
    ``elementwise=True`` additionally promises the body is strictly
    per-element, letting Coalesce run it once on a flat bucket instead of
    once per leaf."""
    return Node(OpKind.MAP, fn=fn, name=name, fusable=fusable,
                elementwise=elementwise)


def Reduce(monoid: Monoid = ADD, axis: Axis = None) -> Node:
    return Node(OpKind.REDUCE, monoid=monoid, axis=axis)


def ReduceScatter(monoid: Monoid = ADD, axis: Axis = None) -> Node:
    return Node(OpKind.REDUCE_SCATTER, monoid=monoid, axis=axis)


def AllGather(axis: Axis = None) -> Node:
    return Node(OpKind.ALLGATHER, axis=axis)


def AllToAll(axis: Axis = None) -> Node:
    return Node(OpKind.ALLTOALL, axis=axis)


def Scan(monoid: Monoid = ADD, exclusive: bool = False,
         axis: Axis = None) -> Node:
    return Node(OpKind.SCAN, monoid=monoid, exclusive=exclusive, axis=axis)


def Bcast(root: int = 0, axis: Axis = None) -> Node:
    return Node(OpKind.BCAST, root=root, axis=axis)


def Wire(codec: WireCodec) -> Node:
    return Node(OpKind.WIRE, codec=codec)


# ---------------------------------------------------------------------------
# DAG IR — the compiler's native program form
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DagNode:
    """One op applied to numbered values.

    Value ids 0..num_inputs-1 are the program inputs; every node defines one
    fresh value (``out``).  Only MAP may take more than one input.
    """

    op: Node
    inputs: tuple[int, ...]
    out: int

    def label(self) -> str:
        return self.op.label()


@dataclasses.dataclass
class DagProgram:
    """A multi-input, multi-output dataflow graph of switch ops.

    ``nodes`` is in value-definition order, which is always a valid
    topological order (a node can only consume already-defined values —
    enforced by :meth:`validate`).
    """

    num_inputs: int
    nodes: Sequence[DagNode]
    outputs: tuple[int, ...]
    name: str = "program"

    def __post_init__(self):
        self.nodes = tuple(self.nodes)
        self.outputs = tuple(self.outputs)
        self.validate()

    def validate(self) -> None:
        defined = set(range(self.num_inputs))
        for nd in self.nodes:
            for vid in nd.inputs:
                if vid not in defined:
                    raise ValueError(
                        f"node {nd.label()} consumes undefined value {vid}")
            if nd.out in defined:
                raise ValueError(f"value {nd.out} defined twice")
            if nd.op.kind == OpKind.MAP:
                if not nd.inputs:
                    raise ValueError("map takes at least one input, got 0")
            elif nd.op.kind == OpKind.MASKED_REDUCE:
                if len(nd.inputs) != 2:
                    raise ValueError(
                        "masked_reduce takes exactly (x, alive), got "
                        f"{len(nd.inputs)} inputs")
            elif len(nd.inputs) != 1:
                raise ValueError(
                    f"{nd.op.kind.value} takes exactly one input, "
                    f"got {len(nd.inputs)}")
            defined.add(nd.out)
        for vid in self.outputs:
            if vid not in defined:
                raise ValueError(f"program output {vid} is undefined")
        if not self.outputs:
            raise ValueError("program has no outputs")

    def users(self) -> dict[int, list[DagNode]]:
        """value id → nodes consuming it (program outputs not included)."""
        out: dict[int, list[DagNode]] = {}
        for nd in self.nodes:
            for vid in nd.inputs:
                out.setdefault(vid, []).append(nd)
        return out

    def labels(self) -> list[str]:
        return [nd.label() for nd in self.nodes]


@dataclasses.dataclass
class SwitchProgram:
    """A linear dataflow chain — kept as a thin shim over the DAG IR.

    The paper's examples (Allgather_op_Allgather, MapReduce) are chains;
    :meth:`to_dag` converts to the compiler's native :class:`DagProgram`.
    Prefer :func:`repro_torch.core.tracing.trace` for new programs.
    """

    nodes: Sequence[Node]
    name: str = "program"

    def __post_init__(self):
        self.nodes = tuple(self.nodes)

    def labels(self) -> list[str]:
        return [n.label() for n in self.nodes]

    def to_dag(self) -> DagProgram:
        """Build the degenerate chain DAG: one input, each node consuming
        the previous node's value.

        Exception (the historical "tuple hack"): the exact chain
        ``[Reduce(m), AllToAll()]`` meant *two independent tensors* — an
        all-reduced histogram plus an all-to-all'd key array — flowing as a
        tuple.  That spelling converts to the true two-input, two-output
        DAG the fusion pattern expects.
        """
        if (len(self.nodes) == 2
                and self.nodes[0].kind == OpKind.REDUCE
                and self.nodes[1].kind == OpKind.ALLTOALL):
            red = DagNode(self.nodes[0], (0,), 2)
            a2a = DagNode(self.nodes[1], (1,), 3)
            return DagProgram(2, (red, a2a), (red.out, a2a.out), self.name)
        dag_nodes: list[DagNode] = []
        vid = 0
        next_vid = 1
        for n in self.nodes:
            dag_nodes.append(DagNode(n, (vid,), next_vid))
            vid = next_vid
            next_vid += 1
        return DagProgram(1, tuple(dag_nodes), (vid,), self.name)
