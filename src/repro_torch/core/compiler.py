"""SwitchProgram compiler — a pass pipeline over the DAG IR.

The PyTorch counterpart of :mod:`repro.core.compiler`.  The passes are
the reference's, rule for rule, so a program compiles to the same stages,
schedules, axes, waves and bucket layout:

  1. :class:`Legalize`   — dead-code-eliminate unused nodes, sink WIRE
     nodes onto the collective they feed, expand MASKED_REDUCE into
     masked_pack → REDUCE.
  2. :class:`LowerTopology` — resolve every collective's ``axis`` against
     the compile :class:`Topology` and rewrite a REDUCE over a
     compound/``"auto"`` axis into the hierarchical RS(inner) →
     REDUCE(outer, codec) → AG(inner) schedule.
  3. :class:`Coalesce`   — bucket per-leaf reductions that share an axis,
     monoid, codec and dtype into flat-buffer bucket stages (plus
     epilogue hoist, batched same-axis rings and RS/AG buckets).
  4. :class:`FuseHops`   — first-class fusion patterns grouped into
     :class:`StageIR` units, topologically ordered.
  5. :class:`SelectSchedule` — latency- vs bandwidth-optimal ring per
     all-reduce stage from the per-rank payload and the
     :mod:`repro_torch.core.netmodel` cost model.
  6. :class:`Emit`       — lower every stage to a rank-local callable run
     eagerly over the active mesh, following an explicit
     :class:`~repro_torch.core.executor.ExecutionPlan`.

The reference's PlaceCGRA pass (CGRA placement of stage bodies) is not
ported yet: every ``placement`` is None, and the cost-model views that
need placements (:meth:`CompiledProgram.program_time`, the model columns
of :meth:`CompiledProgram.explain`) raise ``NotImplementedError``.  So do
the stage lowerings that need ``core/fused.py`` or ``core/lookaside.py``
— when called; they still compile, so the stage structure matches the
reference's.

Rank dims: a compiled program runs on rank-stacked tensors
(``[*rank, *local]``) inside ``with mesh:``.  Every size the compiler
reads is a *local* size: compile-time avals are local shapes, evaluated
on ``meta`` tensors with no rank dims, and the runtime shims go through
the mesh's rank-dim helpers (:meth:`~repro_torch.mesh.Transport.
local_numel`, ``flatten_local``, ``reshape_local``).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Callable, Optional, Sequence, Union

import torch

from repro_torch import mesh as _mesh
from repro_torch.core import collectives, executor, netmodel, ring, switchops
from repro_torch.core.program import (AUTO_AXIS, COLLECTIVE_KINDS, DagNode,
                                      DagProgram, Node, OpKind,
                                      SwitchProgram)
from repro_torch.core.tracing import trace
from repro_torch.core.types import TensorSpec
from repro_torch.core.wire import IDENTITY, resolve_codec
from repro_torch.mesh import LocalMesh, PartitionSpec, ambient, current
from repro_torch.obs import metrics as _obs

PyTree = Any
ProgramLike = Union[DagProgram, SwitchProgram, Callable]

# where each lowering that is not ported yet will come from
_WAITS_FUSED = ("core/fused.py (ROADMAP.md, queue 1 item 2: the Type 3/4 "
                "lowerings)")
_WAITS_LOOKASIDE = ("core/lookaside.py (ROADMAP.md, queue 1 item 2: the "
                    "Type 3/4 lowerings)")
_WAITS_MAPPER = ("PlaceCGRA + cgra/mapper.py (ROADMAP.md, queue 1 item 1)")


def _dtype_name(dtype) -> str:
    """``float32`` / ``bfloat16`` / ... — the reference's dtype spelling,
    used in bucket keys and arena avals."""
    return str(dtype).removeprefix("torch.")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _as_dag(prog: ProgramLike) -> DagProgram:
    if isinstance(prog, DagProgram):
        return prog
    if isinstance(prog, SwitchProgram):
        return prog.to_dag()
    if callable(prog):
        return trace(prog)
    raise TypeError(f"cannot compile {type(prog).__name__}")


# ---------------------------------------------------------------------------
# Topology, compile context & stage forms
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """One data-parallel mesh axis of the compile topology.

    ``tier`` keys into :data:`repro_torch.core.netmodel.TIERS` and tells
    SelectSchedule which link parameters a stage on this axis traverses
    (``"ici"`` fast intra-pod, ``"dci"`` thin inter-pod).  ``size`` may be
    None — collectives then read it at run time from the mesh and
    the cost model falls back to its bandwidth-optimal default.
    """

    name: str
    size: Optional[int] = None
    tier: str = "ici"


@dataclasses.dataclass(frozen=True)
class Topology:
    """The data-parallel axes a program may communicate over, innermost
    (fastest links) first — the compiler's description of where the
    network is fat and where it is thin."""

    axes: tuple[AxisSpec, ...]

    @classmethod
    def single(cls, name: str, size: Optional[int] = None,
               tier: str = "ici") -> "Topology":
        return cls((AxisSpec(name, size, tier),))

    def names(self) -> tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    def spec(self, name: str) -> Optional[AxisSpec]:
        for a in self.axes:
            if a.name == name:
                return a
        return None

    def size(self, name: str) -> Optional[int]:
        a = self.spec(name)
        return a.size if a is not None else None

    def net(self, name: str) -> netmodel.NetParams:
        a = self.spec(name)
        if a is None:
            return netmodel.PAPER
        return netmodel.TIERS.get(a.tier, netmodel.PAPER)

    @property
    def inner(self) -> AxisSpec:
        return self.axes[0]

    @property
    def outer(self) -> Optional[AxisSpec]:
        return self.axes[-1] if len(self.axes) > 1 else None

    def with_sizes(self, sizes: dict) -> "Topology":
        """Fill (or correct) axis sizes from a mesh's {name: size} map."""
        return Topology(tuple(
            dataclasses.replace(a, size=sizes.get(a.name, a.size))
            for a in self.axes))


@dataclasses.dataclass
class CompileContext:
    """Everything the passes may consult.

    ``config`` duck-types :class:`repro_torch.core.api.CollectiveConfig` (only
    ``latency_optimal_below``, ``backend`` and ``codec`` are read) to avoid
    an api↔compiler import cycle.  ``in_avals`` are rank-local shape/dtype
    structs for the program inputs — optional; without them SelectSchedule
    keeps the bandwidth-optimal default.  ``topology`` defaults to the
    single ``axis_name`` axis on the fast tier.
    """

    axis_name: str
    axis_size: Optional[int] = None
    config: Any = None
    in_avals: Optional[Sequence[Any]] = None
    net: netmodel.NetParams = netmodel.PAPER
    dag: Optional[DagProgram] = None    # current form, updated per pass
    topology: Optional[Topology] = None
    # memo for _propagate_avals: (dag object, aval map).  Coalesce and
    # SelectSchedule both need per-value avals; when Coalesce leaves the
    # DAG untouched (the common case) the shape walk runs once.
    aval_memo: Optional[tuple] = None

    @property
    def latency_optimal_below(self) -> Optional[int]:
        if self.config is None:
            return None
        return getattr(self.config, "latency_optimal_below", None)

    def size_of(self, axis: str) -> Optional[int]:
        if self.topology is not None:
            s = self.topology.size(axis)
            if s is not None:
                return s
        return self.axis_size if axis == self.axis_name else None

    def net_of(self, axis: str) -> netmodel.NetParams:
        if self.topology is not None and self.topology.spec(axis) is not None:
            return self.topology.net(axis)
        return self.net

    def default_wire_codec(self):
        """The codec a compressed engine applies at the thin outer hop when
        the program didn't declare one — compression exactly where the
        wire is thin is a compiler decision, not a call-site convention."""
        if self.config is None:
            return IDENTITY
        if "compressed" not in getattr(self.config, "backend", ""):
            return IDENTITY
        return resolve_codec(getattr(self.config, "codec", "identity"))


@dataclasses.dataclass(frozen=True)
class StageIR:
    """One fused group of DAG nodes, pre-emission."""

    kind: str
    nodes: tuple[DagNode, ...]
    in_vids: tuple[int, ...]
    out_vids: tuple[int, ...]
    schedule: str = ""             # "latency" | "bandwidth" | "" (fixed)
    bytes_in: Optional[int] = None
    # per-operand payload split where the summed bytes_in is not enough
    # (the fused AR+A2A pair: (hist bytes, keys bytes) — the shared ring
    # carries them very differently)
    bytes_parts: Optional[tuple[int, ...]] = None
    desc: str = ""
    axis: str = ""                 # mesh axis the stage communicates over
    placement: Optional[Any] = None  # CGRA Placement | HostFallback


@dataclasses.dataclass(frozen=True)
class Stage:
    """One emitted in-network stage: ``run(args, axis_name) -> outputs``.

    ``placement`` is the CGRA mapping of the stage's compute body (None
    until the mapper is ported); ``ir`` is the pre-emission
    :class:`StageIR` the stage was lowered from.
    """

    kind: str
    run: Callable[[tuple, str], tuple]
    desc: str = ""
    in_vids: tuple[int, ...] = ()
    out_vids: tuple[int, ...] = ()
    schedule: str = ""
    axis: str = ""
    placement: Optional[Any] = None
    ir: Optional[StageIR] = None
    # Coalesce bucket packs: index into the program's arena list (the
    # persistent flat buffer this stage may write in place) and the
    # rank-local aval of that buffer.  None for every other stage.
    arena_slot: Optional[int] = None
    arena_aval: Optional[Any] = None

    def __repr__(self):  # pragma: no cover
        return f"Stage({self.kind}@{self.axis})" if self.axis \
            else f"Stage({self.kind})"


@dataclasses.dataclass(eq=False)
class CompiledProgram:
    """Rank-local executable: stages run over a value environment following
    an explicit :class:`~repro_torch.core.executor.ExecutionPlan`.

    Every stage carries its own communication axis (stamped by
    LowerTopology), so one program may span several mesh axes.  The plan
    (dependency edges + concurrency waves, derived from the DAG at
    construction) is the reference's, stage for stage.

    Calling the program always returns a **tuple**, one entry per program
    output — single-output programs return a 1-tuple, not a bare array.

    The program's Coalesce bucket packs may additionally write into
    persistent **arenas**: call :meth:`make_arenas` once and pass the
    buffers to every call (``outs, arenas = prog(*xs, arenas=arenas)``);
    the packs write into them in place, so the pack transient is ~1×
    bucket size instead of 2×.
    """

    stages: Sequence[Stage]
    source: DagProgram
    topology: Optional[Topology] = None
    plan: Optional[executor.ExecutionPlan] = None

    def __post_init__(self):
        if self.plan is None:
            self.plan = executor.build_plan(
                self.stages, self.source.num_inputs, self.source.outputs)

    # -- persistent bucket arenas -------------------------------------------

    @property
    def arena_avals(self) -> tuple:
        """Rank-local aval of every bucket-pack arena, slot order."""
        slots = [st for st in self.stages if st.arena_slot is not None]
        return tuple(st.arena_aval
                     for st in sorted(slots, key=lambda s: s.arena_slot))

    def make_arenas(self, mesh: Optional[LocalMesh] = None
                    ) -> Optional[tuple]:
        """Freshly allocated arena buffers (one flat zeros per bucket
        pack and rank: ``[*rank, bucket]`` on the mesh's device), or None
        when the program has no bucket stages.  ``mesh`` defaults to the
        active one.  Allocate once per program and pass the same tensors
        to every call: the packs write into them in place."""
        avals = self.arena_avals
        if not avals:
            return None
        m = mesh if mesh is not None else current()
        return tuple(torch.zeros(m.rank_shape + tuple(a.shape),
                                 dtype=_dtype(a.dtype), device=m.device)
                     for a in avals)

    def pack_transient_bytes(self, *, arenas: bool = False) -> int:
        """Peak transient bytes of the bucket packs: each pack holds its
        source leaves alive while materializing the flat bucket, so a
        fresh concat peaks at ~2× the bucket; an in-place arena write
        peaks at ~1× (the persistent buffer is not a transient of this
        step, only the leaves are).  Packs sharing a wave have no
        ordering edges between them — the runtime deliberately lets them
        issue concurrently — so their transients are *summed* per wave
        and the peak is the worst wave, not the largest single bucket.
        """
        wave_of = {i: w for w, grp in enumerate(self.plan.waves)
                   for i in grp}
        per_wave: dict[int, int] = {}
        for i, st in enumerate(self.stages):
            if st.arena_aval is None:
                continue
            bucket = _aval_bytes(st.arena_aval)
            w = wave_of.get(i, -1)
            per_wave[w] = per_wave.get(w, 0) \
                + (bucket if arenas else 2 * bucket)
        return max(per_wave.values(), default=0)

    def stage_kinds(self) -> list[str]:
        return [s.kind for s in self.stages]

    def stage_schedules(self) -> list[str]:
        return [s.schedule for s in self.stages]

    def stage_axes(self) -> list[str]:
        return [s.axis for s in self.stages]

    def explain(self, trace=None) -> str:
        """Readable per-stage table: what was fused, which wave of the
        execution plan it runs in (stages sharing a wave are independent
        and may overlap), over which axis, on which ring schedule, with
        which wire codec, and where the compute body landed (CGRA
        placement or explicit host fallback).

        With ``trace`` (a recording whose ``stages`` list of records
        carries ``stage`` and ``duration``), the reference adds measured-vs-model columns; the model needs CGRA
        placements, so here that raises ``NotImplementedError`` until the
        mapper is ported.
        """
        if trace is not None:
            raise NotImplementedError(
                "explain(trace=...) prices stages with the cost model, "
                f"which needs CGRA placements: waits for {_WAITS_MAPPER}")
        if trace is not None and not hasattr(trace, "stages") \
                and hasattr(trace, "trace"):
            trace = trace.trace        # a RunReport: unwrap its trace
        wave_of = {i: w for w, grp in enumerate(self.plan.waves)
                   for i in grp}
        measured: dict[int, float] = {}
        if trace is not None:
            for ts in getattr(trace, "stages", trace):
                measured.setdefault(ts.stage, ts.duration)
        header = ("#", "wave", "kind", "axis", "schedule", "codec",
                  "placement")
        if trace is not None:
            header += ("meas_us", "model_us", "ratio")
        rows = [header]
        ratios: list[tuple[float, int]] = []
        for i, st in enumerate(self.stages):
            codec = "-"
            if st.ir is not None:
                for nd in st.ir.nodes:
                    if nd.op.kind in COLLECTIVE_KINDS \
                            and nd.op.codec is not IDENTITY:
                        codec = nd.op.codec.name
                    elif nd.op.ef is not None:
                        codec = f"ef[{nd.op.ef.compressor}]"
            pl = st.placement.describe() if st.placement is not None \
                else "-"
            kind = st.kind
            if kind == "map" and st.ir is not None:
                # named epilogues (masked_pack/renorm/count, hier_pad, ...)
                # would otherwise all print as an anonymous "map"
                name = next((nd.op.name for nd in st.ir.nodes
                             if nd.op.name), "")
                if name:
                    kind = f"map:{name}"
            row = (str(i), str(wave_of.get(i, "-")), kind,
                   st.axis or "-", st.schedule or "-", codec, pl)
            if trace is not None:
                meas = measured.get(i)
                model = netmodel.plan_stage_time(st, self.topology)
                m_s = f"{meas * 1e6:.1f}" if meas is not None else "-"
                t_s = f"{model * 1e6:.1f}" if model is not None else "-"
                r_s = "-"
                if meas is not None and model:
                    r = meas / model
                    ratios.append((r, i))
                    r_s = f"x{r:.2f}"
                row += (m_s, t_s, r_s)
            rows.append(row)
        ncols = len(rows[0]) - 1         # last column stays ragged
        widths = [max(len(r[c]) for r in rows) for c in range(ncols)]
        lines = [f"program {self.source.name!r} "
                 f"({self.source.num_inputs} in, "
                 f"{len(self.source.outputs)} out, "
                 f"{len(self.stages)} stages, "
                 f"{self.plan.n_waves} waves)"]
        for j, r in enumerate(rows):
            lines.append("  " + "  ".join(
                r[c].ljust(widths[c]) for c in range(ncols))
                + "  " + r[ncols])
            if j == 0:
                lines.append("  " + "-" * (sum(widths) + 2 * ncols
                                           + len(r[ncols])))
        if ratios:
            mean = sum(r for r, _ in ratios) / len(ratios)
            worst = max(ratios, key=lambda t: max(t[0], 1.0 / t[0]))
            lines.append(
                f"  mispredict ratio (meas/model): mean x{mean:.2f}, "
                f"worst x{worst[0]:.2f} @ stage {worst[1]} "
                f"({len(ratios)}/{len(self.stages)} stages priced)")
        elif trace is not None:
            lines.append(
                "  mispredict ratio: no stages priced — the recording's "
                "stage indices don't match this plan")
        else:
            lines.append(
                "  (no recording attached; measured-vs-model columns "
                "need the cost model's CGRA placements)")
        return "\n".join(lines)

    def program_time(self, topology: Optional[Topology] = None) -> float:
        """Analytic wall time of the whole plan (the reference's
        :func:`repro.core.netmodel.program_time`).  It prices MAP-carrying
        stages from their CGRA placement, so it waits for the mapper."""
        raise NotImplementedError(
            f"program_time needs CGRA placements: waits for {_WAITS_MAPPER}")

    def axes(self) -> list[str]:
        """Distinct communication axes, in first-use order."""
        seen: list[str] = []
        for s in self.stages:
            if s.axis and s.axis not in seen:
                seen.append(s.axis)
        return seen

    def __call__(self, *xs: PyTree, arenas: Optional[tuple] = None,
                 instrument: Optional[list] = None) -> tuple:
        """Run the plan over rank-stacked inputs inside ``with mesh:``.
        Without ``arenas``: the output tuple.  With ``arenas`` (from
        :meth:`make_arenas`): ``(outputs, arenas)`` — the bucket packs
        write into the same tensors in place.  ``instrument`` is the
        stage-trace recorder hook (see
        :func:`repro_torch.core.executor.execute`)."""
        n_in = self.source.num_inputs
        if len(xs) == 1 and n_in > 1 and isinstance(xs[0], (tuple, list)):
            xs = tuple(xs[0])      # chain-shim spelling: one tuple argument
        if len(xs) != n_in:
            raise TypeError(
                f"program {self.source.name!r} takes {n_in} inputs, "
                f"got {len(xs)}")
        if arenas is not None:
            rank = current().rank_shape
            avals = self.arena_avals
            if len(arenas) != len(avals):
                raise TypeError(
                    f"program {self.source.name!r} has {len(avals)} "
                    f"bucket arenas, got {len(arenas)}")
            for i, (a, want) in enumerate(zip(arenas, avals)):
                # shape AND dtype must match: the pack would otherwise
                # silently astype-cast every gradient into the arena's
                # dtype (e.g. f32 grads into a bf16 arena)
                if tuple(a.shape) != rank + tuple(want.shape) \
                        or _dtype_name(a.dtype) != want.dtype:
                    raise TypeError(
                        f"program {self.source.name!r} arena {i} must be "
                        f"{rank + tuple(want.shape)} {want.dtype}, got "
                        f"{tuple(a.shape)} "
                        f"{a.dtype} — rebuild the arenas for this "
                        "program (make_arenas / engine.init_arenas with "
                        "matching grad dtypes)")
        return executor.execute(self.plan, xs, arenas=arenas,
                                instrument=instrument)


# ---------------------------------------------------------------------------
# Pass 1: Legalize
# ---------------------------------------------------------------------------

# consumers that can apply a wire codec in-flight (all lower to an
# all-reduce schedule, which takes `codec=`)
_CODEC_SINKS = {OpKind.REDUCE, OpKind.REDUCE_SCATTER, OpKind.MASKED_REDUCE}


def _masked_pack_fn(monoid) -> Callable:
    """Legalize-side expansion of MASKED_REDUCE: mask the payload with the
    monoid identity (``where``, not multiply — ``0 * NaN`` would poison
    the ring) and append this rank's alive flag as one trailing lane, so
    the live count folds in the *same* flat buffer as the payload.  Under
    ``add`` the trailing lane reduces to the live count; under other
    monoids it is the monoid-fold of the alive flags (renormalization is
    add-only and rejected at trace time otherwise)."""
    def masked_pack(x, alive):
        tp = ambient()
        a = tp.reshape_local(alive, ()).to(x.dtype)
        flat = tp.flatten_local(x)
        fill = monoid.identity(TensorSpec(tuple(flat.shape), x.dtype,
                                          x.device))
        body = torch.where(tp.rank_bcast(a != 0, flat), flat, fill)
        return torch.cat([body, a.reshape(tp.rank_shape + (1,))], dim=-1)
    masked_pack.masked_monoid = monoid
    return masked_pack


class Legalize:
    """Canonicalize the DAG: DCE + sink WIRE nodes onto their consumer +
    expand MASKED_REDUCE into masked_pack → REDUCE (the count lane rides
    the payload's flat buffer — one ring, not two launches)."""

    name = "legalize"

    def run(self, dag: DagProgram, ctx: CompileContext) -> DagProgram:
        dag = self._dce(dag)
        dag = self._sink_wires(dag)
        return self._expand_masked(dag)

    @staticmethod
    def _expand_masked(dag: DagProgram) -> DagProgram:
        """MASKED_REDUCE(x, alive) → masked_pack MAP → REDUCE.

        Runs after ``_sink_wires`` so a codec sunk onto the masked reduce
        transfers to the emitted REDUCE (it rides the same hop the
        payload does).  The expansion is total: MASKED_REDUCE must never
        survive Legalize — no later pass can lower it.
        """
        if not any(nd.op.kind == OpKind.MASKED_REDUCE for nd in dag.nodes):
            return dag
        next_vid = max(
            [dag.num_inputs - 1] + [nd.out for nd in dag.nodes]) + 1
        nodes: list[DagNode] = []
        for nd in dag.nodes:
            if nd.op.kind != OpKind.MASKED_REDUCE:
                nodes.append(nd)
                continue
            pack_out = next_vid
            next_vid += 1
            nodes.append(DagNode(
                Node(OpKind.MAP, fn=_masked_pack_fn(nd.op.monoid),
                     name="masked_pack", fusable=False),
                nd.inputs, pack_out))
            nodes.append(DagNode(
                Node(OpKind.REDUCE, monoid=nd.op.monoid,
                     codec=nd.op.codec, axis=nd.op.axis),
                (pack_out,), nd.out))
        return DagProgram(dag.num_inputs, tuple(nodes), dag.outputs,
                          dag.name)

    @staticmethod
    def _dce(dag: DagProgram) -> DagProgram:
        live = set(dag.outputs)
        keep: list[DagNode] = []
        for nd in reversed(dag.nodes):
            if nd.out in live:
                keep.append(nd)
                live.update(nd.inputs)
        keep.reverse()
        if len(keep) == len(dag.nodes):
            return dag
        return DagProgram(dag.num_inputs, tuple(keep), dag.outputs, dag.name)

    @staticmethod
    def _sink_wires(dag: DagProgram) -> DagProgram:
        """Replace WIRE nodes by a ``codec`` attribute on their consumer.

        The codec travels through single-input MAPs (the map runs before
        the payload hits the wire, so the declaration still applies to the
        collective downstream — the old chain compiler's pending-codec
        behaviour).  A WIRE reaching a non-codec-capable op or a program
        output is dropped — the wire format of those links is fixed — and
        the drop is *announced* with a ``UserWarning`` naming the node, so
        a user who declared compression on a link that cannot apply it
        learns the codec was ignored instead of silently paying f32 wire
        bytes they thought they'd saved.
        """
        if not any(nd.op.kind == OpKind.WIRE for nd in dag.nodes):
            return dag
        alias: dict[int, int] = {}       # wire out → its input
        carried: dict[int, Any] = {}     # value id → pending codec

        def resolve(vid: int) -> int:
            while vid in alias:
                vid = alias[vid]
            return vid

        def warn_drop(codec, where: str) -> None:
            warnings.warn(
                f"[{dag.name}] wire codec {codec.name!r} dropped at "
                f"{where} — that link's wire format is fixed, the "
                "declared compression will NOT be applied",
                UserWarning, stacklevel=3)

        nodes: list[DagNode] = []
        applied: set[int] = set()        # carried vids whose codec sank
        for nd in dag.nodes:
            if nd.op.kind == OpKind.WIRE:
                alias[nd.out] = nd.inputs[0]
                carried[nd.out] = nd.op.codec
                continue
            op = nd.op
            ins = tuple(resolve(v) for v in nd.inputs)
            codecs = [carried[v] for v in nd.inputs if v in carried]
            if codecs:
                # an error-feedback reduce is not codec-capable — its wire
                # format is the compressor's, so a WIRE reaching it drops
                # like on any fixed-function link
                if op.kind in _CODEC_SINKS and op.ef is None:
                    op = dataclasses.replace(op, codec=codecs[-1])
                    applied.update(v for v in nd.inputs if v in carried)
                elif op.kind == OpKind.MAP and len(nd.inputs) == 1:
                    carried[nd.out] = codecs[-1]
                elif op.kind in _CODEC_SINKS:
                    warn_drop(codecs[-1],
                              f"error-feedback node {op.label()!r} (its "
                              "wire format is the compressor's)")
                else:
                    warn_drop(codecs[-1],
                              f"non-codec-capable node {op.label()!r}")
            nodes.append(DagNode(op, ins, nd.out))
        for v in dag.outputs:
            # a pending codec that reached an output without ever sinking
            # (directly, or carried through maps) was silently useless
            if v in carried and v not in applied:
                warn_drop(carried[v], "a program output")
        outputs = tuple(resolve(v) for v in dag.outputs)
        return DagProgram(dag.num_inputs, tuple(nodes), outputs, dag.name)


# ---------------------------------------------------------------------------
# Pass 2: LowerTopology — resolve axes, lower compound reductions
# ---------------------------------------------------------------------------

def _flatten_pad(inner_axes: tuple[str, ...],
                 monoid=None, quant_safe: bool = False) -> Callable:
    """Flatten to 1-D and pad to a multiple of the product of the inner
    axis sizes, so the reduce-scatter chain can chunk evenly.  The sizes
    come from the active mesh — no static size needed at compile time.

    Pad lanes carry the reduce monoid's identity so per-hop combines never
    see invented values (a literal 0 clamps ``min`` / annihilates ``prod``).
    ``quant_safe`` forces a zero fill instead: a blockwise-quant codec on
    the outer hop shares one scale per block, and a huge identity element
    (e.g. max's -3.4e38) in the tail block would absorb the real lanes'
    resolution — the pad lanes themselves are sliced off by hier_unpad.
    """
    def fn(x):
        tp = ambient()
        n = 1
        for ax in inner_axes:
            n *= tp.axis_size(ax)
        m = None if quant_safe else monoid
        return ring.pad_to_multiple(tp.flatten_local(x), n, monoid=m)[0]
    # expose the axes so _propagate_avals can size the pad statically
    fn.inner_axes = tuple(inner_axes)
    return fn


def _unpad_like(y, orig):
    """Undo :func:`_flatten_pad` using the original operand for shape."""
    return y[..., :ambient().local_numel(orig)].reshape(orig.shape)


class LowerTopology:
    """Make topology a compiler concern.

    Every collective's ``axis`` is resolved against ``ctx.topology``:
    ``None`` → the engine default axis, ``"auto"`` → all DP axes of the
    topology, a tuple → that compound axis (innermost first).  A REDUCE
    over a compound axis is rewritten into the hierarchical schedule

        pad → RS(inner…) → REDUCE(outer, codec) → AG(…inner) → unpad

    so the later passes fuse/schedule/emit *per axis*.  A sunk wire codec
    (or a compressed engine's default codec) rides the outer hop only —
    the payload crossing the thin inter-pod links is already 1/|inner| of
    the gradient, and it is the only place compression pays.  An
    error-feedback REDUCE instead compresses at the innermost tier (where
    its DELIVERED sibling lives) and reduces the outer tiers exactly.
    """

    name = "lower_topology"

    def run(self, dag: DagProgram, ctx: CompileContext) -> DagProgram:
        nodes: list[DagNode] = []
        vmap: dict[int, int] = {i: i for i in range(dag.num_inputs)}
        next_vid = dag.num_inputs

        def emit(op: Node, ins: Sequence[int]) -> int:
            nonlocal next_vid
            vid = next_vid
            next_vid += 1
            nodes.append(DagNode(op, tuple(ins), vid))
            return vid

        for nd in dag.nodes:
            ins = tuple(vmap[v] for v in nd.inputs)
            op = nd.op
            if op.kind not in COLLECTIVE_KINDS:
                vmap[nd.out] = emit(op, ins)
                continue
            axes = self._resolve(op.axis, ctx)
            if len(axes) == 1 or op.kind == OpKind.DELIVERED:
                # DELIVERED is rank-local feedback of the innermost-tier
                # compression — it never spans tiers
                vmap[nd.out] = emit(
                    dataclasses.replace(op, axis=axes[0]), ins)
            elif op.kind == OpKind.REDUCE:
                vmap[nd.out] = self._lower_reduce(op, ins[0], axes, ctx,
                                                  emit)
            else:
                raise NotImplementedError(
                    f"{op.kind.value} over compound axis {axes} has no "
                    "hierarchical lowering (only reduce does)")
        return DagProgram(dag.num_inputs, tuple(nodes),
                          tuple(vmap[v] for v in dag.outputs), dag.name)

    @staticmethod
    def _resolve(axis, ctx: CompileContext) -> tuple[str, ...]:
        if axis is None:
            return (ctx.axis_name,)
        if axis == AUTO_AXIS:
            if ctx.topology is None:
                return (ctx.axis_name,)
            return ctx.topology.names()
        if isinstance(axis, str):
            return (axis,)
        return tuple(axis)

    def _lower_reduce(self, op: Node, vin: int, axes: tuple[str, ...],
                      ctx: CompileContext, emit) -> int:
        if op.ef is not None:
            # error feedback applies at the innermost tier; the outer
            # tiers reduce the (already compressed) partials exactly
            v = emit(dataclasses.replace(op, axis=axes[0]), (vin,))
            for ax in axes[1:]:
                v = emit(Node(OpKind.REDUCE, monoid=op.monoid, axis=ax),
                         (v,))
            return v
        inner, outer = axes[:-1], axes[-1]
        codec = op.codec
        if codec is IDENTITY:
            codec = ctx.default_wire_codec()
        # pad/unpad are shape bookkeeping, not chunk-local compute — they
        # must not be hop-fused into the ring schedules
        quant_safe = codec.combine_encoded is not None
        p = emit(Node(OpKind.MAP,
                      fn=_flatten_pad(inner, monoid=op.monoid,
                                      quant_safe=quant_safe),
                      name="hier_pad", fusable=False), (vin,))
        for ax in inner:
            p = emit(Node(OpKind.REDUCE_SCATTER, monoid=op.monoid, axis=ax),
                     (p,))
        p = emit(Node(OpKind.REDUCE, monoid=op.monoid, codec=codec,
                      axis=outer), (p,))
        for ax in reversed(inner):
            p = emit(Node(OpKind.ALLGATHER, axis=ax), (p,))
        return emit(Node(OpKind.MAP, fn=_unpad_like, name="hier_unpad",
                         fusable=False), (p, vin))


# ---------------------------------------------------------------------------
# Pass 3: Coalesce — bucket per-leaf reductions into flat-buffer stages
# ---------------------------------------------------------------------------

def _propagate_avals(dag: DagProgram,
                     ctx: CompileContext) -> dict[int, TensorSpec]:
    """Best-effort rank-local aval for every DAG value.

    Program inputs come from ``ctx.in_avals``; MAP outputs by running the
    body on ``meta`` tensors of the local shape with no mesh axis bound
    (the port's ``jax.eval_shape``: a body that queries an axis size —
    e.g. the hier pad/mean bookkeeping — simply stays unknown, as in the
    reference); collectives preserve their
    input aval except AG/RS, which scale the leading dim by their axis
    size when it is known.
    """
    if ctx.in_avals is None:
        return {}
    if ctx.aval_memo is not None and ctx.aval_memo[0] is dag:
        return ctx.aval_memo[1]
    avals: dict[int, TensorSpec] = {}
    for i, a in enumerate(ctx.in_avals):
        try:
            avals[i] = TensorSpec(tuple(a.shape), a.dtype)
        except Exception:
            pass
    for nd in dag.nodes:
        ins = [avals.get(v) for v in nd.inputs]
        if any(a is None for a in ins):
            continue
        k = nd.op.kind
        if k == OpKind.MAP:
            try:
                with _mesh.Unranked():
                    out = nd.op.fn(*(torch.empty(a.shape, dtype=a.dtype,
                                                 device="meta")
                                     for a in ins))
            except Exception:
                # hier_pad advertises its axes — size the pad statically
                inner = getattr(nd.op.fn, "inner_axes", None)
                if inner:
                    n = 1
                    for ax in inner:
                        sz = ctx.size_of(ax)
                        if not sz:
                            n = None
                            break
                        n *= sz
                    if n:
                        flat = int(math.prod(ins[0].shape)) \
                            if ins[0].shape else 1
                        avals[nd.out] = TensorSpec(
                            (-(-flat // n) * n,), ins[0].dtype)
                continue
            if isinstance(out, torch.Tensor):
                avals[nd.out] = TensorSpec(tuple(out.shape), out.dtype)
        elif k == OpKind.ALLGATHER:
            n = SelectSchedule._axis_size(nd, ctx)
            if n and ins[0].shape:
                avals[nd.out] = TensorSpec(
                    (ins[0].shape[0] * n,) + tuple(ins[0].shape[1:]),
                    ins[0].dtype)
        elif k == OpKind.REDUCE_SCATTER:
            n = SelectSchedule._axis_size(nd, ctx)
            if n and ins[0].shape:
                avals[nd.out] = TensorSpec(
                    (max(ins[0].shape[0] // n, 1),)
                    + tuple(ins[0].shape[1:]), ins[0].dtype)
        elif k != OpKind.WIRE:
            avals[nd.out] = ins[0]
    ctx.aval_memo = (dag, avals)
    return avals


def _aval_bytes(aval) -> int:
    size = int(math.prod(aval.shape)) if aval.shape else 1
    dt = aval.dtype if isinstance(aval.dtype, torch.dtype) \
        else _dtype(aval.dtype)
    return size * dt.itemsize


def _pack_fn(sizes: tuple[int, ...], dtype: str = "float32") -> Callable:
    """Emit-side shim: flatten every leaf and concat into one flat bucket.

    The bucket layout (split offsets) was computed from the compile
    ``in_avals`` — if a leaf shows up at run time with a different
    element count, slicing would silently hand every downstream leaf the
    wrong gradient, so the mismatch is rejected at trace time instead.

    The per-leaf sizes and bucket dtype ride on the function as
    ``bucket_sizes`` / ``bucket_dtype``: Emit reads them to lower the
    pack as an in-place **arena write** into a persistent flat buffer
    instead of a fresh concatenation when the caller passes arenas.
    """
    def pack(*xs):
        _check_pack_sizes(xs, sizes)
        tp = ambient()
        return torch.cat([tp.flatten_local(x) for x in xs], dim=-1)
    pack.bucket_sizes = sizes
    pack.bucket_dtype = dtype
    return pack


def _check_pack_sizes(xs, sizes: tuple[int, ...]) -> None:
    tp = ambient()
    for i, (x, s) in enumerate(zip(xs, sizes)):
        if tp.local_numel(x) != s:
            raise ValueError(
                f"Coalesce bucket pack: leaf {i} has {tp.local_numel(x)} "
                f"elements at run time but the compile in_avals "
                f"promised {s} — pass in_avals matching the "
                "rank-local shapes (bucket offsets are computed "
                "from them)")


def _split_fn(offset: int, size: int) -> Callable:
    """Emit-side shim: slice one leaf back out of a reduced flat bucket,
    shaped like the original operand (runtime shape, not the aval — a
    rank-local leading dim of 1 survives the round trip)."""
    def split(b, orig):
        return b[..., offset:offset + size].reshape(orig.shape)
    return split


def _masked_bucket_pack_fn(sizes: tuple[int, ...], dtype: str,
                           monoid) -> Callable:
    """Bucket pack for masked reductions: mask every leaf with the monoid
    identity (``where`` on the shared alive flag — the last argument) and
    append ONE trailing count lane for the whole bucket, so k masked
    leaves still cost one ring with a single extra element.

    ``bucket_sizes`` includes the count lane (size 1); ``masked_monoid``
    tells Emit's arena path to pre-mask the leaves before the in-place
    writes (the arena write is otherwise raw)."""
    def masked_bucket_pack(*args):
        xs, alive = args[:-1], args[-1]
        _check_pack_sizes(xs, sizes)
        tp = ambient()
        a = tp.reshape_local(alive, ()).to(_dtype(dtype))
        live = a != 0
        parts = []
        for x in xs:
            flat = tp.flatten_local(x).to(_dtype(dtype))
            fill = monoid.identity(
                TensorSpec(tuple(flat.shape), flat.dtype, flat.device))
            parts.append(torch.where(tp.rank_bcast(live, flat), flat, fill))
        parts.append(a.reshape(tp.rank_shape + (1,)))
        return torch.cat(parts, dim=-1)
    masked_bucket_pack.bucket_sizes = tuple(sizes) + (1,)
    masked_bucket_pack.bucket_dtype = dtype
    masked_bucket_pack.masked_monoid = monoid
    return masked_bucket_pack


def _masked_bucket_renorm_fn() -> Callable:
    """Whole-bucket renormalize epilogue: divide the payload lanes by the
    reduced live count (clamped — a transiently all-dead view must not
    divide by zero) and drop the count lane.  One kernel per bucket, the
    masked analogue of the hoisted mean epilogue."""
    def bucket_masked_renorm(b):
        n = b.shape[-1] - 1
        cnt = torch.clamp_min(b[..., n:n + 1], 1)
        return b[..., :n] / cnt.to(b.dtype)
    return bucket_masked_renorm


def _masked_bucket_count_fn() -> Callable:
    def bucket_masked_count(b):
        n = b.shape[-1] - 1
        return torch.clamp_min(b[..., n:n + 1], 1).reshape(b.shape[:-1])
    return bucket_masked_count


def _rs_pack_fn(sizes: tuple[int, ...], n: int) -> Callable:
    """Layout-aware pack for a REDUCE_SCATTER bucket.

    Chunk boundaries must align with the scatter axis: each flat leaf is
    viewed as ``(n, size/n)`` and the leaves are concatenated chunk-wise
    (axis 1), so rank ``j``'s scattered share of the bucket is exactly
    the concatenation of every leaf's own chunk ``j`` — pure data
    movement, bit-identical to the per-leaf scatters."""
    def pack(*xs):
        _check_pack_sizes(xs, sizes)
        tp = ambient()
        return tp.reshape_local(torch.cat(
            [tp.reshape_local(x, (n, -1)) for x in xs], dim=-1), (-1,))
    return pack


def _rs_split_fn(offset: int, chunk: int, n: int) -> Callable:
    """Slice one leaf's scattered chunk back out of a bucket RS result
    (the bucket output is one rank-chunk: ``sum(size_i / n)`` long)."""
    def split(b, orig):
        tp = ambient()
        loc = tp.local_shape(orig)
        shp = (loc[0] // n,) + tuple(loc[1:])
        return tp.reshape_local(b[..., offset:offset + chunk], shp)
    return split


def _ag_split_fn(offset: int, size: int, n: int) -> Callable:
    """Slice one leaf's gathered result out of a bucket AG output: the
    output is n rank-copies of the flat bucket back to back, so leaf
    ``i`` is column block ``[offset, offset+size)`` of the (n, S) view."""
    def split(b, orig):
        tp = ambient()
        loc = tp.local_shape(orig)
        shp = (loc[0] * n,) + tuple(loc[1:])
        return tp.reshape_local(
            tp.reshape_local(b, (n, -1))[..., offset:offset + size], shp)
    return split


def _ring_batch_pack_fn(sizes: tuple[int, ...], chunks: tuple[int, ...],
                        n: int, monoid) -> Callable:
    """Pack k independent same-axis allreduce payloads into ONE
    chunk-aligned stacked buffer (the batched ring launch).

    Each flat leaf is padded to ``n * chunk_i`` with the monoid identity
    — the same pad :func:`repro_torch.core.ring.pad_to_multiple` would apply
    inside its own ring — viewed as ``(n, chunk_i)`` and concatenated
    along axis 1.  Every lane therefore keeps its original chunk index,
    hence its exact per-hop fold order: the batched ring is
    *bit-identical* to the k separate rings (for both the bandwidth RS∘AG
    walk, whose fold path is chunk-indexed, and the latency log-step,
    whose fold order is lane-independent)."""
    def pack(*xs):
        _check_pack_sizes(xs, sizes)
        tp = ambient()
        cols = []
        for x, c in zip(xs, chunks):
            flat = tp.flatten_local(x)
            pad = n * c - flat.shape[-1]
            if pad:
                fill = monoid.identity(TensorSpec(
                    tp.rank_shape + (pad,), flat.dtype, flat.device))
                flat = torch.cat([flat, fill], dim=-1)
            cols.append(tp.reshape_local(flat, (n, c)))
        return tp.reshape_local(torch.cat(cols, dim=-1), (-1,))
    return pack


def _ring_batch_split_fn(offset: int, chunk: int, size: int,
                         n: int) -> Callable:
    """Recover one payload from a batched-ring result: take its column
    block of the (n, C) view, drop the identity pad lanes, reshape."""
    def split(b, orig):
        tp = ambient()
        col = tp.reshape_local(b, (n, -1))[..., offset:offset + chunk]
        return tp.flatten_local(col)[..., :size].reshape(orig.shape)
    return split


@dataclasses.dataclass
class _ReduceUnit:
    """One bucketable per-leaf reduction — a plain REDUCE, an
    error-feedback REDUCE(+DELIVERED sibling, + trailing outer reduces),
    or a whole LowerTopology hierarchical pad→RS…→AR→…AG→unpad chain.
    All three are elementwise across ranks and shape-preserving end to
    end, which is exactly what makes concat-then-split legal."""

    kind: str           # "reduce" | "ef" | "hier" | "rs" | "ag" | "masked"
    vin: int                        # the leaf value feeding the unit
    out_red: int                    # the unit's reduced output value
    out_dlv: Optional[int]          # DELIVERED sibling output (ef only) —
    #                                 the shared count output for "masked"
    nodes: tuple[DagNode, ...]      # claimed by this unit
    key: tuple                      # bucketing group key
    nbytes: int
    size: int
    shape: tuple
    ops: dict                       # replay ops for the bucket rebuild
    dtype: str = "float32"          # leaf (= bucket) dtype
    aux: tuple = ()                 # extra consumed vids (the masked
    #                                 units' shared alive flag) — part of
    #                                 the bucket's dependency footprint


class Coalesce:
    """Bucket same-axis/monoid/codec per-leaf reductions into flat-buffer
    bucket stages.

    A transformer's gradient sync emits one reduce per pytree leaf —
    hundreds of collectives, each paying the full ring latency.  This
    pass concatenates the leaves of compatible reductions into fixed-byte
    buckets (sized by :func:`repro_torch.core.netmodel.bucket_bytes` from the
    latency/bandwidth crossover of the axis actually traversed, or the
    ``CollectiveConfig.bucket_bytes`` override; ``0`` disables the pass),
    runs **one** collective per bucket, and splits the results back per
    leaf — pack/split are ordinary MAP shims, so the per-leaf API is
    unchanged and `gradient_sync` numerics are preserved: exactly (up to
    summation order) for plain reductions and hierarchical chains, and
    within the compression's own error bars for blockwise error-feedback
    compressors (block boundaries shift across the concat).  Top-k EF is
    deliberately *not* bucketized — global selection over a concat would
    change which gradients ship — and data-dependent reductions never
    share a bucket.

    Runs between LowerTopology and FuseHops: axes are resolved (the
    group key is exact) and the hierarchical RS/AR/AG chains LowerTopology
    emitted are bucketized whole — the bucket replays the same chain
    once.  Leaves whose aval is unknown, groups of one, and buckets of
    one stay untouched.
    """

    name = "coalesce"

    def __init__(self, bucket_bytes: Optional[int] = None):
        self.bucket_bytes = bucket_bytes

    def run(self, dag: DagProgram, ctx: CompileContext) -> DagProgram:
        override = self.bucket_bytes
        if override is None and ctx.config is not None:
            override = getattr(ctx.config, "bucket_bytes", None)
        if ctx.in_avals is None:
            return dag
        if override != 0:
            avals = _propagate_avals(dag, ctx)
            units = self._find_units(dag, avals, ctx)
            buckets = self._form_buckets(units, ctx, override, dag)
            if buckets:
                hoist = True
                if ctx.config is not None:
                    hoist = getattr(ctx.config, "epilogue_hoist", True)
                dag = self._rewrite(dag, buckets, hoist=hoist)
        if ctx.config is not None and getattr(ctx.config, "batch_rings",
                                              False):
            dag = self._batch_rings(dag, ctx)
        return dag

    # -- unit discovery ------------------------------------------------------

    def _find_units(self, dag: DagProgram, avals: dict,
                    ctx: CompileContext) -> list[_ReduceUnit]:
        users = dag.users()
        out_set = set(dag.outputs)
        producer_of = {nd.out: nd for nd in dag.nodes}
        claimed: set[int] = set()

        def sole_user(vid: int) -> Optional[DagNode]:
            us = users.get(vid, [])
            if len(us) == 1 and vid not in out_set \
                    and us[0].out not in claimed:
                return us[0]
            return None

        # DELIVERED siblings indexed once — _match_ef must not rescan the
        # whole DAG per EF reduce (O(leaves²) on big gradient pytrees)
        delivered: dict[tuple, DagNode] = {}
        for nd in dag.nodes:
            if nd.op.kind == OpKind.DELIVERED:
                delivered.setdefault((nd.inputs, nd.op.axis, nd.op.ef), nd)

        units: list[_ReduceUnit] = []
        for nd in dag.nodes:
            if nd.out in claimed or not nd.inputs:
                continue
            aval = avals.get(nd.inputs[0])
            u = None
            if aval is not None:
                if nd.op.kind == OpKind.REDUCE and nd.op.ef is not None:
                    u = self._match_ef(nd, delivered, aval, claimed,
                                       sole_user)
                elif nd.op.kind == OpKind.REDUCE:
                    u = self._match_reduce(nd, aval)
                elif nd.op.kind == OpKind.MAP \
                        and nd.op.name == "masked_pack":
                    u = self._match_masked(nd, aval, users, out_set,
                                           claimed, sole_user)
                elif nd.op.kind == OpKind.MAP and nd.op.name == "hier_pad":
                    u = self._match_hier(nd, aval, sole_user)
                elif nd.op.kind == OpKind.REDUCE_SCATTER:
                    u = self._match_rs(nd, aval, users, ctx)
                elif nd.op.kind == OpKind.ALLGATHER:
                    u = self._match_ag(nd, aval, users, producer_of, ctx)
            if u is not None:
                units.append(u)
                claimed.update(g.out for g in u.nodes)
        return units

    @staticmethod
    def _leaf_meta(aval) -> tuple[int, int, tuple, str]:
        size = int(math.prod(aval.shape)) if aval.shape else 1
        return (_aval_bytes(aval), size, tuple(aval.shape),
                _dtype_name(aval.dtype))

    def _match_reduce(self, nd: DagNode, aval) -> Optional[_ReduceUnit]:
        nbytes, size, shape, dt = self._leaf_meta(aval)
        key = ("reduce", nd.op.axis, nd.op.monoid.name, nd.op.codec.name,
               dt)
        return _ReduceUnit("reduce", nd.inputs[0], nd.out, None, (nd,),
                           key, nbytes, size, shape, {"red": nd.op}, dt)

    def _match_rs(self, nd: DagNode, aval, users,
                  ctx: CompileContext) -> Optional[_ReduceUnit]:
        """Standalone REDUCE_SCATTER leaf (sharded-optimizer style).

        Bucketizable because the pack is chunk-aligned with the scatter
        axis (see :func:`_rs_pack_fn`) — each rank's share of the bucket
        is the concat of its per-leaf shares.  Requires the leading dim
        divisible by the axis size (otherwise the per-leaf op itself
        defines the ragged split and we leave it alone)."""
        if nd.op.ef is not None:
            return None
        ax = nd.op.axis
        if not isinstance(ax, str) or ax == AUTO_AXIS:
            return None
        n = ctx.size_of(ax)
        if not n or n < 2 or not aval.shape or aval.shape[0] % n:
            return None
        us = users.get(nd.out, [])
        if len(us) == 1 and us[0].op.kind == OpKind.ALLGATHER \
                and us[0].op.axis == ax:
            # RS feeding a same-axis AG is FuseHops' RsAgPattern — the
            # pair rebuilds the bandwidth-optimal allreduce; don't split
            # the pattern across a bucket boundary
            return None
        nbytes, size, shape, dt = self._leaf_meta(aval)
        key = ("rs", ax, nd.op.monoid.name, nd.op.codec.name, dt)
        return _ReduceUnit("rs", nd.inputs[0], nd.out, None, (nd,), key,
                           nbytes, size, shape,
                           {"red": nd.op, "n": n}, dt)

    def _match_ag(self, nd: DagNode, aval, users, producer_of,
                  ctx: CompileContext) -> Optional[_ReduceUnit]:
        """Standalone ALLGATHER leaf — pure data movement, so a plain
        concat bucket gathers once and the splits de-interleave the
        (n, bucket) result per leaf."""
        ax = nd.op.axis
        if not isinstance(ax, str) or ax == AUTO_AXIS:
            return None
        n = ctx.size_of(ax)
        if not n or n < 2 or not aval.shape:
            return None
        prod = producer_of.get(nd.inputs[0])
        if prod is not None and prod.op.kind == OpKind.REDUCE_SCATTER \
                and prod.op.axis == ax:
            return None                     # RsAgPattern territory
        us = users.get(nd.out, [])
        if len(us) == 1 and us[0].op.kind == OpKind.MAP \
                and us[0].op.fusable and len(us[0].inputs) == 1:
            return None                     # GatherMapPattern territory
        nbytes, size, shape, dt = self._leaf_meta(aval)
        key = ("ag", ax, dt)
        return _ReduceUnit("ag", nd.inputs[0], nd.out, None, (nd,), key,
                           nbytes, size, shape,
                           {"red": nd.op, "n": n}, dt)

    def _match_ef(self, nd: DagNode, delivered: dict, aval,
                  claimed: set, sole_user) -> Optional[_ReduceUnit]:
        if nd.op.ef.compressor == "topk":
            # top-k selects globally over its operand: run over a concat
            # bucket it would starve small-magnitude leaves in favor of
            # large ones — a semantic change, not a layout change.  The
            # blockwise compressors (int8 shared-scale: one scale per
            # 256-element block) only shift block boundaries, which stays
            # within the compression's own error bars.
            return None
        dlv = delivered.get((nd.inputs, nd.op.axis, nd.op.ef))
        if dlv is not None and dlv.out in claimed:
            dlv = None
        # trailing plain outer reduces (the hierarchical EF lowering:
        # compress at the innermost tier, reduce the outer tiers exactly)
        outer: list[DagNode] = []
        cur = nd
        while True:
            u = sole_user(cur.out)
            if (u is not None and u.op.kind == OpKind.REDUCE
                    and u.op.ef is None and len(u.inputs) == 1):
                outer.append(u)
                cur = u
            else:
                break
        nbytes, size, shape, dt = self._leaf_meta(aval)
        ef = nd.op.ef
        key = ("ef", nd.op.axis, nd.op.monoid.name, ef.compressor,
               round(ef.topk_ratio, 9),
               tuple((o.op.axis, o.op.monoid.name, o.op.codec.name)
                     for o in outer),
               dlv is not None, dt)
        nodes = (nd,) + tuple(outer) + ((dlv,) if dlv is not None else ())
        return _ReduceUnit("ef", nd.inputs[0], cur.out,
                           dlv.out if dlv is not None else None,
                           nodes, key, nbytes, size, shape,
                           {"red": nd.op,
                            "dlv": dlv.op if dlv is not None else None,
                            "outer": tuple(o.op for o in outer)}, dt)

    def _match_masked(self, pack: DagNode, aval, users, out_set,
                      claimed: set, sole_user) -> Optional[_ReduceUnit]:
        """A whole Legalize masked-reduce chain, bucketized to stage
        parity with the unmasked path:

            masked_pack(x, alive) → [REDUCE | hier pad→RS…→AR→…AG→unpad]
                → masked_renorm(+ masked_count)

        k such units sharing (axes, monoid, codec, dtype, alive flag,
        renormalize) collapse into ONE bucket: one masked pack with a
        single trailing count lane, one ring, one whole-bucket renorm
        epilogue, k splits — the masked sync costs what the unmasked
        bucket costs plus one element.
        """
        x_vid, alive_vid = pack.inputs
        if pack.out in out_set:
            return None
        pus = [u for u in users.get(pack.out, [])]
        if any(u.out in claimed for u in pus):
            return None
        chain: tuple[DagNode, ...]
        ops: dict
        if len(pus) == 1 and pus[0].op.kind == OpKind.REDUCE \
                and pus[0].op.ef is None:
            red = pus[0]
            chain = (red,)
            ops = {"red": red.op}
            red_out = red.out
            axes_sig = (red.op.axis,)
        elif len(pus) == 2:
            # the LowerTopology hierarchical chain: pack.out feeds both
            # hier_pad and (as shape donor) hier_unpad
            pads = [u for u in pus if u.op.name == "hier_pad"]
            unpads = [u for u in pus if u.op.name == "hier_unpad"]
            if len(pads) != 1 or len(unpads) != 1:
                return None
            hu = self._match_hier(pads[0], aval, sole_user)
            if hu is None or hu.nodes[-1] is not unpads[0]:
                return None
            chain = hu.nodes
            ops = dict(hu.ops)
            red_out = hu.out_red
            axes_sig = (tuple(op.axis for op in ops["rs"]),
                        ops["red"].axis)
        else:
            return None
        if red_out in out_set:
            return None
        rus = users.get(red_out, [])
        renorm = count = None
        for u in rus:
            if u.out in claimed:
                return None
            if (u.op.kind == OpKind.MAP and u.op.name == "masked_renorm"
                    and len(u.inputs) == 2 and u.inputs[1] == x_vid
                    and renorm is None):
                renorm = u
            elif (u.op.kind == OpKind.MAP
                    and u.op.name == "masked_count"
                    and len(u.inputs) == 1 and count is None):
                count = u
            else:
                return None
        if renorm is None:
            return None
        nbytes, size, shape, dt = self._leaf_meta(aval)
        renormalize = bool(getattr(renorm.op.fn, "masked_renormalize",
                                   True))
        ops["renormalize"] = renormalize
        ops["alive"] = alive_vid
        red_op = ops["red"]
        key = ("masked", axes_sig, red_op.monoid.name, red_op.codec.name,
               dt, alive_vid, renormalize)
        nodes = (pack,) + chain + (renorm,) \
            + ((count,) if count is not None else ())
        return _ReduceUnit("masked", x_vid, renorm.out,
                           count.out if count is not None else None,
                           nodes, key, nbytes, size, shape, ops, dt,
                           aux=(alive_vid,))

    def _match_hier(self, pad: DagNode, aval,
                    sole_user) -> Optional[_ReduceUnit]:
        rs: list[DagNode] = []
        u = sole_user(pad.out)
        while u is not None and u.op.kind == OpKind.REDUCE_SCATTER:
            rs.append(u)
            u = sole_user(u.out)
        if not rs or u is None or u.op.kind != OpKind.REDUCE \
                or u.op.ef is not None:
            return None
        red = u
        ag: list[DagNode] = []
        u = sole_user(red.out)
        while u is not None and u.op.kind == OpKind.ALLGATHER:
            ag.append(u)
            u = sole_user(u.out)
        unpad = u
        if (unpad is None or unpad.op.kind != OpKind.MAP
                or unpad.op.name != "hier_unpad"
                or len(unpad.inputs) != 2
                or unpad.inputs[1] != pad.inputs[0]
                or len(ag) != len(rs)
                or [n.op.axis for n in ag]
                != [n.op.axis for n in reversed(rs)]):
            return None
        nbytes, size, shape, dt = self._leaf_meta(aval)
        key = ("hier", tuple(n.op.axis for n in rs), red.op.axis,
               red.op.monoid.name, red.op.codec.name, dt)
        nodes = (pad,) + tuple(rs) + (red,) + tuple(ag) + (unpad,)
        return _ReduceUnit("hier", pad.inputs[0], unpad.out, None, nodes,
                           key, nbytes, size, shape,
                           {"pad": pad.op, "rs": tuple(n.op for n in rs),
                            "red": red.op, "ag": tuple(n.op for n in ag),
                            "unpad": unpad.op}, dt)

    # -- bucket formation ----------------------------------------------------

    @staticmethod
    def _primary_axis(u: _ReduceUnit) -> Optional[str]:
        """The first link tier the unit's payload traverses (sizes the
        bucket): the reduce's own axis, or the innermost RS axis of a
        hierarchical chain."""
        hier = u.kind == "hier" or (u.kind == "masked" and u.ops.get("rs"))
        ax = u.ops["rs"][0].axis if hier else u.ops["red"].axis
        return ax if isinstance(ax, str) and ax != AUTO_AXIS else None

    @staticmethod
    def _value_ancestors(dag: DagProgram) -> dict[int, set[int]]:
        anc: dict[int, set[int]] = {}
        for nd in dag.nodes:
            a: set[int] = set()
            for v in nd.inputs:
                a.add(v)
                a |= anc.get(v, set())
            anc[nd.out] = a
        return anc

    def _form_buckets(self, units: list[_ReduceUnit], ctx: CompileContext,
                      override: Optional[int],
                      dag: DagProgram) -> list[list[_ReduceUnit]]:
        """Greedy byte-capped packing, dependency-safe.

        A unit whose input transitively depends on a current bucket
        member's output must not join that bucket (the pack would need a
        value the bucket itself produces); it is deferred to a later
        round and may still bucket with its own level.  A final
        Kahn check over the bucket graph dissolves any bucket whose
        grouping would knot buckets into a cycle through intermediate
        nodes — unbucketed lowering is always legal, just less coalesced
        (same policy as FuseHops' cross-branch fusion).
        """
        anc = self._value_ancestors(dag)
        groups: dict[tuple, list[_ReduceUnit]] = {}
        for u in units:
            groups.setdefault(u.key, []).append(u)
        buckets: list[list[_ReduceUnit]] = []
        for us in groups.values():
            if override:
                cap = override
            else:
                ax = self._primary_axis(us[0])
                cap = netmodel.bucket_bytes(
                    ctx.size_of(ax) if ax else None,
                    ctx.net_of(ax) if ax else netmodel.PAPER)
            pending = us
            while len(pending) >= 2:
                cur: list[_ReduceUnit] = []
                cur_bytes = 0
                cur_outs: set[int] = set()
                deferred: list[_ReduceUnit] = []

                def close():
                    nonlocal cur, cur_bytes, cur_outs
                    if len(cur) >= 2:
                        buckets.append(cur)
                        _obs.RECORDER.observe("coalesce.bucket_fill_frac",
                                              cur_bytes / cap)
                    cur, cur_bytes, cur_outs = [], 0, set()

                for u in pending:       # definition order throughout
                    if any(o in anc.get(v, ())
                           for v in (u.vin,) + u.aux for o in cur_outs):
                        deferred.append(u)      # retry next round
                        continue
                    if cur and cur_bytes + u.nbytes > cap:
                        close()                 # full: start the next one
                    cur.append(u)
                    cur_bytes += u.nbytes
                    cur_outs.add(u.out_red)
                    if u.out_dlv is not None:
                        cur_outs.add(u.out_dlv)
                close()
                if len(deferred) >= len(pending):
                    break       # no progress (unreachable: the first unit
                    #             of a round always enters cur) — safety
                pending = deferred
        return self._drop_cyclic(buckets, anc)

    @staticmethod
    def _drop_cyclic(buckets: list[list[_ReduceUnit]],
                     anc: dict[int, set[int]]) -> list[list[_ReduceUnit]]:
        """Dissolve buckets participating in a bucket-graph cycle.

        Rare shape: two buckets each holding a unit whose input depends
        (through *another* member of the other bucket) on the first —
        individually independent units, knotted only by the grouping.
        """
        while True:
            outs_of = [
                {u.out_red for u in b}
                | {u.out_dlv for u in b if u.out_dlv is not None}
                for b in buckets]
            indeg = [0] * len(buckets)
            succs: list[list[int]] = [[] for _ in buckets]
            for i, b in enumerate(buckets):
                for j, outs in enumerate(outs_of):
                    if i != j and any(o in anc.get(v, ())
                                      for u in b
                                      for v in (u.vin,) + u.aux
                                      for o in outs):
                        succs[j].append(i)
                        indeg[i] += 1
            ready = [i for i, d in enumerate(indeg) if d == 0]
            seen = 0
            while ready:
                i = ready.pop()
                seen += 1
                for s in succs[i]:
                    indeg[s] -= 1
                    if indeg[s] == 0:
                        ready.append(s)
            if seen == len(buckets):
                return buckets
            # dissolve a bucket actually ON a cycle, not one merely
            # downstream of the knot (which Kahn also leaves with
            # residual indegree)
            residual = {i for i, d in enumerate(indeg) if d > 0}

            def on_cycle(start: int) -> bool:
                stack, visited = list(succs[start]), set()
                while stack:
                    i = stack.pop()
                    if i == start:
                        return True
                    if i in visited or i not in residual:
                        continue
                    visited.add(i)
                    stack.extend(succs[i])
                return False

            drop = next(i for i in sorted(residual) if on_cycle(i))
            buckets = buckets[:drop] + buckets[drop + 1:]

    # -- the rewrite ---------------------------------------------------------

    def _find_epilogues(self, dag: DagProgram,
                        buckets: list[list[_ReduceUnit]],
                        claimed_outs: set[int]) -> tuple[dict, dict]:
        """Per-bucket elementwise epilogue hoist.

        When every unit's reduced output feeds exactly one *identical*
        single-input MAP declared ``elementwise`` (the gradient sync's
        shared mean), that map runs once on the flat bucket instead of
        once per leaf — a many-leaf sync then issues one bucket-sized
        kernel rather than N tiny ones.  The hoist is only taken for a
        whole bucket (all units share the fn object), and only on the
        caller's explicit elementwise promise: ``f(concat(xs)) ==
        concat(f(x))`` is what makes running it before the split legal.
        Returns ({bucket idx → hoisted op}, {bucket idx → per-unit map
        out vids}); the hoisted map nodes are added to ``claimed_outs``.
        """
        users = dag.users()
        out_set = set(dag.outputs)
        epilogues: dict[int, Node] = {}
        epi_outs: dict[int, list[int]] = {}
        for bi, b in enumerate(buckets):
            hoisted: list[DagNode] = []
            for u in b:
                us = users.get(u.out_red, [])
                if (len(us) == 1 and u.out_red not in out_set
                        and us[0].op.kind == OpKind.MAP
                        and len(us[0].inputs) == 1
                        and us[0].op.elementwise
                        and us[0].out not in claimed_outs):
                    hoisted.append(us[0])
                else:
                    break
            if len(hoisted) != len(b) \
                    or len({h.op.fn for h in hoisted}) != 1:
                continue
            epilogues[bi] = dataclasses.replace(
                hoisted[0].op, name="bucket_epilogue", fusable=False)
            epi_outs[bi] = [h.out for h in hoisted]
            claimed_outs.update(h.out for h in hoisted)
        return epilogues, epi_outs

    def _rewrite(self, dag: DagProgram,
                 buckets: list[list[_ReduceUnit]], *,
                 hoist: bool = True) -> DagProgram:
        claimed_outs = {nd.out for b in buckets for u in b
                        for nd in u.nodes}
        # epilogue hoist is a tunable (CollectiveConfig.epilogue_hoist):
        # per-leaf epilogues trade one big kernel for wave-level overlap
        epilogues, epi_outs = (
            self._find_epilogues(dag, buckets, claimed_outs)
            if hoist else ({}, {}))
        producers: dict[int, tuple] = {}
        for nd in dag.nodes:
            if nd.out not in claimed_outs:
                producers[nd.out] = ("node", nd)
        for bi, b in enumerate(buckets):
            for u in b:
                producers[u.out_red] = ("bucket", bi)
                if u.out_dlv is not None:
                    producers[u.out_dlv] = ("bucket", bi)
            for v in epi_outs.get(bi, ()):
                producers[v] = ("bucket", bi)

        nodes_out: list[DagNode] = []
        vmap: dict[int, int] = {i: i for i in range(dag.num_inputs)}
        next_vid = [dag.num_inputs]

        def emit(op: Node, ins: Sequence[int]) -> int:
            vid = next_vid[0]
            next_vid[0] += 1
            nodes_out.append(DagNode(op, tuple(ins), vid))
            return vid

        emitted: set[int] = set()

        def get(vid: int) -> int:
            got = vmap.get(vid)
            if got is not None:
                return got
            tag, obj = producers[vid]
            if tag == "node":
                ins = tuple(get(v) for v in obj.inputs)
                vmap[vid] = emit(obj.op, ins)
            else:
                emit_bucket(obj)
            return vmap[vid]

        def emit_bucket(bi: int) -> None:
            if bi in emitted:
                return
            emitted.add(bi)
            us = buckets[bi]
            ins = tuple(get(u.vin) for u in us)
            ops = us[0].ops
            if us[0].kind == "masked":
                # one masked pack over every leaf plus the shared alive
                # flag: a single trailing count lane serves the bucket
                ins = ins + (get(ops["alive"]),)
                pack = emit(Node(OpKind.MAP,
                                 fn=_masked_bucket_pack_fn(
                                     tuple(u.size for u in us),
                                     us[0].dtype, ops["red"].monoid),
                                 name="bucket_pack", fusable=False), ins)
            elif us[0].kind == "rs":
                # scatter-axis-aligned interleave, NOT the arena concat
                # layout — no bucket_sizes attr, so Emit never hands
                # this pack an arena
                pack = emit(Node(OpKind.MAP,
                                 fn=_rs_pack_fn(
                                     tuple(u.size for u in us),
                                     ops["n"]),
                                 name="bucket_pack_rs", fusable=False),
                            ins)
            else:
                pack = emit(Node(OpKind.MAP,
                                 fn=_pack_fn(tuple(u.size for u in us),
                                             us[0].dtype),
                                 name="bucket_pack", fusable=False), ins)
            v_dlv = None
            v_cnt = None
            if us[0].kind == "masked":
                if ops.get("rs"):              # hierarchical masked chain
                    v = emit(ops["pad"], (pack,))
                    for op in ops["rs"]:
                        v = emit(op, (v,))
                    v = emit(ops["red"], (v,))
                    for op in ops["ag"]:
                        v = emit(op, (v,))
                    v_raw = emit(ops["unpad"], (v, pack))
                else:
                    v_raw = emit(ops["red"], (pack,))
                if any(u.out_dlv is not None for u in us):
                    v_cnt = emit(Node(OpKind.MAP,
                                      fn=_masked_bucket_count_fn(),
                                      name="masked_count",
                                      fusable=False), (v_raw,))
                if ops["renormalize"]:
                    # the whole-bucket renorm epilogue — one kernel per
                    # bucket, the masked analogue of the hoisted mean
                    v_red = emit(Node(OpKind.MAP,
                                      fn=_masked_bucket_renorm_fn(),
                                      name="masked_renorm",
                                      fusable=False), (v_raw,))
                else:
                    # splits read the payload lanes straight off the
                    # reduced buffer; the count lane sits past them
                    v_red = v_raw
            elif us[0].kind in ("reduce", "rs", "ag"):
                v_red = emit(ops["red"], (pack,))
            elif us[0].kind == "ef":
                v_red = emit(ops["red"], (pack,))
                if ops["dlv"] is not None:
                    v_dlv = emit(ops["dlv"], (pack,))
                for op in ops["outer"]:
                    v_red = emit(op, (v_red,))
            else:                                        # "hier"
                v = emit(ops["pad"], (pack,))
                for op in ops["rs"]:
                    v = emit(op, (v,))
                v = emit(ops["red"], (v,))
                for op in ops["ag"]:
                    v = emit(op, (v,))
                v_red = emit(ops["unpad"], (v, pack))
            epi = epilogues.get(bi)
            v_epi = emit(epi, (v_red,)) if epi is not None else None
            off = 0
            for k, u in enumerate(us):
                orig = vmap[u.vin]      # runtime shape donor for the slice
                if u.kind == "rs":
                    chunk = u.size // ops["n"]
                    split = Node(OpKind.MAP,
                                 fn=_rs_split_fn(off, chunk, ops["n"]),
                                 name="bucket_split", fusable=False)
                elif u.kind == "ag":
                    split = Node(OpKind.MAP,
                                 fn=_ag_split_fn(off, u.size, ops["n"]),
                                 name="bucket_split", fusable=False)
                else:
                    split = Node(OpKind.MAP, fn=_split_fn(off, u.size),
                                 name="bucket_split", fusable=False)
                if v_epi is not None:
                    # the hoisted epilogue replaced every per-leaf map:
                    # the split of the epilogued bucket IS that map's
                    # output (u.out_red itself had no other consumer)
                    vmap[epi_outs[bi][k]] = emit(split, (v_epi, orig))
                else:
                    vmap[u.out_red] = emit(split, (v_red, orig))
                if u.out_dlv is not None:
                    if u.kind == "masked":
                        # the live count is one shared scalar, not a
                        # per-leaf slice
                        vmap[u.out_dlv] = v_cnt
                    else:
                        dsplit = Node(OpKind.MAP,
                                      fn=_split_fn(off, u.size),
                                      name="bucket_split", fusable=False)
                        vmap[u.out_dlv] = emit(dsplit, (v_dlv, orig))
                # rs split offsets walk the per-rank chunk, not the leaf
                off += u.size // ops["n"] if u.kind == "rs" else u.size

        for nd in dag.nodes:
            p = producers.get(nd.out)
            if p is not None and p[0] == "node":
                get(nd.out)
        for v in dag.outputs:
            get(v)
        return DagProgram(dag.num_inputs, tuple(nodes_out),
                          tuple(vmap[v] for v in dag.outputs), dag.name)

    # -- batched same-axis ring launch ---------------------------------------

    _BATCHABLE_MONOIDS = ("add", "max", "min", "prod")

    # default per-member payload cap for batching.  Merging amortizes
    # the fixed per-launch hop walk, which only matters while a ring is
    # latency-bound; a bandwidth-bound member gains nothing and loses
    # twice — it can no longer pipeline against its siblings, and the
    # stacked buffer spills the per-hop working set out of cache
    # (measured: merging MB-scale bucket rings on the host backend is a
    # slowdown, merging tens-of-KB rings is ~2x).  So: members above the
    # cap keep their own launch, members below it merge, and one merged
    # launch's total payload is bounded at 8x the cap.
    _BATCH_RINGS_BYTES = 256 << 10

    @staticmethod
    def _cap_groups(g: list, cap: Optional[int]) -> list[list]:
        """Partition a batch group under the payload cap: drop members
        above ``cap`` bytes (they stay per-program launches), greedily
        pack the rest smallest-first into sub-groups of at most
        ``8 * cap`` total.  ``cap`` 0/None = merge everything.  Only
        sub-groups of >= 2 survive — a singleton batches nothing."""
        if not cap:
            return [g] if len(g) >= 2 else []
        small = [t for t in g if _aval_bytes(t[2]) <= cap]
        out: list[list] = []
        cur: list = []
        cur_bytes = 0
        for t in sorted(small, key=lambda t: _aval_bytes(t[2])):
            b = _aval_bytes(t[2])
            if cur and cur_bytes + b > 8 * cap:
                out.append(cur)
                cur, cur_bytes = [], 0
            cur.append(t)
            cur_bytes += b
        out.append(cur)
        return [s for s in out if len(s) >= 2]

    @staticmethod
    def _drop_group_cycles(merges: list, anc: dict) -> list:
        """Dissolve batch groups knotted into a cycle through other
        groups' members (same policy as :meth:`_drop_cyclic`): members
        are independent *within* a group, but group A may feed group B
        through intermediates while B feeds A — merging both would
        deadlock; per-program launches stay legal."""
        while len(merges) > 1:
            k = len(merges)
            outs = [{nd.out for nd, _, _ in g} for _, g in merges]
            indeg = [0] * k
            succs: list[list[int]] = [[] for _ in range(k)]
            for i in range(k):
                for j in range(k):
                    if i != j and any(
                            (anc.get(nd.inputs[0], set())
                             | {nd.inputs[0]}) & outs[i]
                            for nd, _, _ in merges[j][1]):
                        succs[i].append(j)
                        indeg[j] += 1
            ready = [i for i, d in enumerate(indeg) if d == 0]
            seen = 0
            while ready:
                i = ready.pop()
                seen += 1
                for s in succs[i]:
                    indeg[s] -= 1
                    if indeg[s] == 0:
                        ready.append(s)
            if seen == k:
                break
            drop = next(i for i, d in enumerate(indeg) if d > 0)
            merges = merges[:drop] + merges[drop + 1:]
        return merges

    def _batch_rings(self, dag: DagProgram,
                     ctx: CompileContext) -> DagProgram:
        """Merge a program's independent same-axis ring collectives —
        allreduces, reduce-scatters, all-gathers — into ONE launch per
        (kind, axis, monoid, dtype) over a chunk-aligned stacked buffer.

        After bucketing, a big sync is a handful of bucket allreduces on
        the same axis — each still a separate ring launch paying the full
        per-hop dispatch latency.  When the combine is a plain
        elementwise Type 1 monoid and the codec is identity, k of them
        collapse into a single launch: pack (chunk-aligned, identity-
        padded — see :func:`_ring_batch_pack_fn`), one REDUCE tagged
        ``batched_ring:k``, k splits.  Bit-compatible with the separate
        launches because every lane keeps its chunk index, hence its
        per-hop fold order.  (When group members would straddle the
        latency/bandwidth crossover, the batched buffer makes one
        schedule decision for all of them — same numerics up to float
        reassociation, which is the usual schedule-choice caveat.)
        """
        avals = _propagate_avals(dag, ctx)
        anc = self._value_ancestors(dag)
        groups: dict[tuple, list] = {}
        for nd in dag.nodes:
            op = nd.op
            if (op.name or "").startswith("batched_ring"):
                continue
            ax = op.axis
            if not isinstance(ax, str) or ax == AUTO_AXIS:
                continue
            n = ctx.size_of(ax)
            if not n or n < 2:
                continue
            aval = avals.get(nd.inputs[0])
            if aval is None:
                continue
            dt = _dtype_name(aval.dtype)
            if op.kind == OpKind.REDUCE:
                if (op.ef is not None or op.codec.name != "identity"
                        or op.monoid.name not in self._BATCHABLE_MONOIDS):
                    continue
                key = ("red", ax, op.monoid.name, dt)
            elif op.kind == OpKind.REDUCE_SCATTER:
                # same chunk-aligned layout as the RS bucket pack; the
                # merged op needs every leading dim divisible by n
                if (op.ef is not None or op.codec.name != "identity"
                        or op.monoid.name not in self._BATCHABLE_MONOIDS
                        or not aval.shape or aval.shape[0] % n):
                    continue
                key = ("rs", ax, op.monoid.name, dt)
            elif op.kind == OpKind.ALLGATHER:
                if not aval.shape:
                    continue
                key = ("ag", ax, dt)
            else:
                continue
            groups.setdefault(key, []).append((nd, n, aval))

        cap = getattr(ctx.config, "batch_rings_bytes", None) \
            if ctx.config is not None else None
        if cap is None:
            cap = self._BATCH_RINGS_BYTES
        merges: list[tuple[str, list]] = []
        for key, g in groups.items():
            outs = {nd.out for nd, _, _ in g}
            # keep only mutually independent members: a collective whose
            # input (transitively) needs another member's output cannot
            # share its launch
            indep = [t for t in g
                     if not ((anc.get(t[0].inputs[0], set())
                              | {t[0].inputs[0]}) & outs)]
            for sub in self._cap_groups(indep, cap):
                merges.append((key[0], sub))
        merges = self._drop_group_cycles(merges, anc)
        if not merges:
            return dag

        member: dict[int, int] = {}
        for gi, (_, g) in enumerate(merges):
            for nd, _, _ in g:
                member[nd.out] = gi
        producers: dict[int, tuple] = {}
        for nd in dag.nodes:
            if nd.out in member:
                producers[nd.out] = ("group", member[nd.out])
            else:
                producers[nd.out] = ("node", nd)

        nodes_out: list[DagNode] = []
        vmap: dict[int, int] = {i: i for i in range(dag.num_inputs)}
        next_vid = [dag.num_inputs]
        emitted: set[int] = set()

        def emit(op: Node, ins: Sequence[int]) -> int:
            vid = next_vid[0]
            next_vid[0] += 1
            nodes_out.append(DagNode(op, tuple(ins), vid))
            return vid

        def get(vid: int) -> int:
            got = vmap.get(vid)
            if got is not None:
                return got
            tag, obj = producers[vid]
            if tag == "node":
                ins = tuple(get(v) for v in obj.inputs)
                vmap[vid] = emit(obj.op, ins)
            else:
                emit_group(obj)
            return vmap[vid]

        def emit_group(gi: int) -> None:
            if gi in emitted:
                return
            emitted.add(gi)
            ckind, g = merges[gi]
            n = g[0][1]
            op0 = g[0][0].op
            sizes = tuple(
                int(math.prod(a.shape)) if a.shape else 1
                for _, _, a in g)
            ins = tuple(get(nd.inputs[0]) for nd, _, _ in g)
            if ckind == "red":
                chunks = tuple(-(-s // n) for s in sizes)
                pack = emit(Node(OpKind.MAP,
                                 fn=_ring_batch_pack_fn(sizes, chunks, n,
                                                        op0.monoid),
                                 name="ring_batch_pack", fusable=False),
                            ins)
                red = emit(dataclasses.replace(
                    op0, name=f"batched_ring:{len(g)}"), (pack,))
                off = 0
                for (nd, _, _), s, c in zip(g, sizes, chunks):
                    split = Node(OpKind.MAP,
                                 fn=_ring_batch_split_fn(off, c, s, n),
                                 name="ring_batch_split", fusable=False)
                    vmap[nd.out] = emit(split,
                                        (red, vmap[nd.inputs[0]]))
                    off += c
            elif ckind == "rs":
                # chunk-aligned stacking (the RS bucket layout): rank
                # j's share of the merged buffer is the concat of its
                # per-member shares
                pack = emit(Node(OpKind.MAP, fn=_rs_pack_fn(sizes, n),
                                 name="ring_batch_pack_rs",
                                 fusable=False), ins)
                red = emit(dataclasses.replace(
                    op0, name=f"batched_ring_rs:{len(g)}"), (pack,))
                off = 0
                for (nd, _, _), s in zip(g, sizes):
                    split = Node(OpKind.MAP,
                                 fn=_rs_split_fn(off, s // n, n),
                                 name="ring_batch_split_rs",
                                 fusable=False)
                    vmap[nd.out] = emit(split,
                                        (red, vmap[nd.inputs[0]]))
                    off += s // n
            else:                                      # "ag"
                pack = emit(Node(OpKind.MAP,
                                 fn=lambda *xs: torch.cat(
                                     [ambient().flatten_local(x)
                                      for x in xs], dim=-1),
                                 name="ring_batch_pack_ag",
                                 fusable=False), ins)
                red = emit(dataclasses.replace(
                    op0, name=f"batched_ring_ag:{len(g)}"), (pack,))
                off = 0
                for (nd, _, _), s in zip(g, sizes):
                    split = Node(OpKind.MAP,
                                 fn=_ag_split_fn(off, s, n),
                                 name="ring_batch_split_ag",
                                 fusable=False)
                    vmap[nd.out] = emit(split,
                                        (red, vmap[nd.inputs[0]]))
                    off += s

        for nd in dag.nodes:
            if producers[nd.out][0] == "node":
                get(nd.out)
        for v in dag.outputs:
            get(v)
        return DagProgram(dag.num_inputs, tuple(nodes_out),
                          tuple(vmap[v] for v in dag.outputs), dag.name)


# ---------------------------------------------------------------------------
# Pass 4: FuseHops — first-class fusion patterns
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _MatchState:
    """Shared lookup tables for pattern matching over one DAG."""

    dag: DagProgram
    users: dict[int, list[DagNode]]
    out_set: set[int]
    claimed: set[int]                       # node out-ids already grouped
    ancestors: dict[int, set[int]]          # node out → transitive inputs

    @classmethod
    def build(cls, dag: DagProgram) -> "_MatchState":
        anc: dict[int, set[int]] = {}
        for nd in dag.nodes:
            a: set[int] = set()
            for v in nd.inputs:
                a.add(v)
                a |= anc.get(v, set())
            anc[nd.out] = a
        return cls(dag, dag.users(), set(dag.outputs), set(), anc)

    def sole_user(self, vid: int) -> Optional[DagNode]:
        """The unique consumer of ``vid`` if it isn't also a program
        output (fusion would hide the intermediate value) and hasn't been
        claimed by an earlier match (a cross-branch pattern may grab a
        node defined after the current root)."""
        us = self.users.get(vid, [])
        if len(us) == 1 and vid not in self.out_set \
                and us[0].out not in self.claimed:
            return us[0]
        return None

    def independent(self, a: DagNode, b: DagNode) -> bool:
        return a.out not in self.ancestors[b.out] \
            and b.out not in self.ancestors[a.out]


class FusionPattern:
    """One fusion rule: try to build a :class:`StageIR` rooted at ``nd``."""

    name = "pattern"

    def match(self, nd: DagNode, st: _MatchState) -> Optional[StageIR]:
        raise NotImplementedError


def _stage_axis(*nds: DagNode) -> str:
    """The (shared) communication axis of a fused group — the first
    collective node's axis; MAP nodes are axis-less."""
    for nd in nds:
        if nd.op.kind in COLLECTIVE_KINDS and isinstance(nd.op.axis, str) \
                and nd.op.axis != AUTO_AXIS:
            return nd.op.axis
    return ""


def _same_axis(*nds: DagNode) -> bool:
    """Collectives may only fuse onto one schedule if they traverse the
    same mesh axis (a pod-local ring cannot carry inter-pod hops)."""
    axes = {nd.op.axis for nd in nds if nd.op.kind in COLLECTIVE_KINDS}
    return len(axes) <= 1


class ScanGatherPattern(FusionPattern):
    """AG ∘ SCAN ∘ AG → fused scan+gather (paper Fig. 5)."""

    name = "scan+allgather"

    def match(self, nd, st):
        if nd.op.kind != OpKind.ALLGATHER:
            return None
        scan = st.sole_user(nd.out)
        if scan is None or scan.op.kind != OpKind.SCAN:
            return None
        ag2 = st.sole_user(scan.out)
        if ag2 is None or ag2.op.kind != OpKind.ALLGATHER \
                or not _same_axis(nd, scan, ag2):
            return None
        mono = scan.op.monoid
        return StageIR("scan+allgather", (nd, scan, ag2),
                       nd.inputs, (ag2.out,),
                       axis=_stage_axis(nd),
                       desc=f"fused allgather_op_allgather "
                            f"(in-network {mono.name}-scan)")


class MapIntoReducePattern(FusionPattern):
    """MAP ∘ REDUCE / MAP ∘ REDUCE_SCATTER → hop-fused map (Type 4)."""

    name = "map+reduce"

    def match(self, nd, st):
        if nd.op.kind != OpKind.MAP or len(nd.inputs) != 1 \
                or not nd.op.fusable:
            return None
        red = st.sole_user(nd.out)
        if red is None or red.op.kind not in (OpKind.REDUCE,
                                              OpKind.REDUCE_SCATTER) \
                or red.op.ef is not None:
            return None
        if red.op.kind == OpKind.REDUCE:
            return StageIR("map+allreduce", (nd, red), nd.inputs, (red.out,),
                           axis=_stage_axis(red),
                           desc="map fused ahead of AR schedule")
        return StageIR("map+reduce_scatter", (nd, red), nd.inputs,
                       (red.out,),
                       axis=_stage_axis(red),
                       desc=f"map({nd.op.name or 'fn'}) fused into RS hops")


class GatherMapPattern(FusionPattern):
    """ALLGATHER ∘ MAP → map applied in-flight at the forwarding hop."""

    name = "allgather+map"

    def match(self, nd, st):
        if nd.op.kind != OpKind.ALLGATHER:
            return None
        mp = st.sole_user(nd.out)
        if mp is None or mp.op.kind != OpKind.MAP or len(mp.inputs) != 1 \
                or not mp.op.fusable:
            return None
        return StageIR("allgather+map", (nd, mp), nd.inputs, (mp.out,),
                       axis=_stage_axis(nd),
                       desc="map applied in-flight at forwarding hop")


class ReduceAlltoallPattern(FusionPattern):
    """Independent REDUCE(add) + ALLTOALL pair → one shared ring schedule
    (the NAS IS histogram/keys fusion)."""

    name = "allreduce+alltoall"

    def match(self, nd, st):
        pair = None
        if self._fusable_reduce(nd):
            pair = self._find(nd, OpKind.ALLTOALL, st)
            red, a2a = nd, pair
        elif nd.op.kind == OpKind.ALLTOALL:
            pair = self._find(nd, OpKind.REDUCE, st)
            red, a2a = pair, nd
        if pair is None:
            return None
        return StageIR("allreduce+alltoall", (red, a2a),
                       (red.inputs[0], a2a.inputs[0]),
                       (red.out, a2a.out),
                       schedule="latency",
                       axis=_stage_axis(red),
                       desc="fused AR+A2A on one ring traversal")

    @staticmethod
    def _fusable_reduce(nd: DagNode) -> bool:
        # the shared-schedule kernel implements the add combine on the
        # identity wire only — a sunk codec must go to the unfused AR,
        # and an error-feedback reduce is a look-aside stage of its own
        return (nd.op.kind == OpKind.REDUCE
                and nd.op.monoid.name == "add"
                and nd.op.codec is IDENTITY
                and nd.op.ef is None)

    def _find(self, nd: DagNode, kind: OpKind,
              st: _MatchState) -> Optional[DagNode]:
        for cand in st.dag.nodes:
            if (cand.op.kind == kind and cand.out not in st.claimed
                    and (kind != OpKind.REDUCE
                         or self._fusable_reduce(cand))
                    and _same_axis(nd, cand)
                    and st.independent(nd, cand)):
                return cand
        return None


class RsAgPattern(FusionPattern):
    """REDUCE_SCATTER ∘ ALLGATHER → one all-reduce schedule."""

    name = "allreduce"

    def match(self, nd, st):
        if nd.op.kind != OpKind.REDUCE_SCATTER:
            return None
        ag = st.sole_user(nd.out)
        if ag is None or ag.op.kind != OpKind.ALLGATHER \
                or not _same_axis(nd, ag):
            return None
        return StageIR("allreduce", (nd, ag), nd.inputs, (ag.out,),
                       axis=_stage_axis(nd),
                       desc="RS∘AG → ring AR")


class EfPairPattern(FusionPattern):
    """Error-feedback REDUCE + its DELIVERED sibling → one look-aside
    stage: the compression runs once and yields both the lossy total and
    the locally-delivered contribution (the residual's other half)."""

    name = "ef_allreduce"

    def match(self, nd, st):
        if nd.op.kind != OpKind.REDUCE or nd.op.ef is None:
            return None
        for cand in st.dag.nodes:
            if (cand.op.kind == OpKind.DELIVERED
                    and cand.out not in st.claimed
                    and cand.inputs == nd.inputs
                    and cand.op.axis == nd.op.axis
                    and cand.op.ef == nd.op.ef):
                return StageIR("ef_allreduce", (nd, cand), nd.inputs,
                               (nd.out, cand.out),
                               axis=_stage_axis(nd),
                               desc=f"error-feedback "
                                    f"{nd.op.ef.compressor} all-reduce "
                                    "(Type 3 look-aside)")
        return None     # residual DCE'd — _single emits the lone reduce


DEFAULT_PATTERNS: tuple[FusionPattern, ...] = (
    EfPairPattern(),
    ScanGatherPattern(),
    MapIntoReducePattern(),
    GatherMapPattern(),
    ReduceAlltoallPattern(),
    RsAgPattern(),
)


_SINGLE_KINDS = {
    OpKind.MAP: "map",
    OpKind.REDUCE: "allreduce",
    OpKind.REDUCE_SCATTER: "reduce_scatter",
    OpKind.ALLGATHER: "allgather",
    OpKind.ALLTOALL: "alltoall",
    OpKind.SCAN: "scan",
    OpKind.BCAST: "bcast",
    OpKind.DELIVERED: "delivered",
}


class FuseHops:
    """Greedily apply fusion patterns in definition order, then
    topologically order the resulting stage groups."""

    name = "fuse_hops"

    def __init__(self, patterns: Sequence[FusionPattern] = DEFAULT_PATTERNS):
        self.patterns = tuple(patterns)

    def run(self, dag: DagProgram, ctx: CompileContext) -> list[StageIR]:
        st = _MatchState.build(dag)
        groups: list[StageIR] = []
        for nd in dag.nodes:
            if nd.out in st.claimed:
                continue
            for pat in self.patterns:
                m = pat.match(nd, st)
                if m is not None:
                    groups.append(m)
                    st.claimed.update(g.out for g in m.nodes)
                    break
            else:
                groups.append(self._single(nd))
                st.claimed.add(nd.out)
        # Cross-branch fusions (AR+A2A pairs) can deadlock each other at
        # the group level even though each pair is node-independent: two
        # pairs may each consume a value the other produces.  Dissolve
        # fused groups until the group graph is acyclic — unfused
        # lowering is always legal, just less fused.
        while True:
            cyclic = self._find_cycle_member(groups)
            if cyclic is None:
                break
            groups = [g for g in groups if g is not cyclic] \
                + [self._single(nd) for nd in cyclic.nodes]
        return self._topo(groups)

    @staticmethod
    def _find_cycle_member(groups: list[StageIR]) -> Optional[StageIR]:
        """A multi-node group participating in a group-graph cycle, or
        None if the group graph is already acyclic (Kahn's algorithm)."""
        produced_by = {v: g for g in groups for v in g.out_vids}
        succs: dict[int, list[StageIR]] = {id(g): [] for g in groups}
        indeg = {id(g): 0 for g in groups}
        for g in groups:
            for v in g.in_vids:
                dep = produced_by.get(v)
                if dep is not None and dep is not g:
                    succs[id(dep)].append(g)
                    indeg[id(g)] += 1
        ready = [g for g in groups if indeg[id(g)] == 0]
        seen = 0
        while ready:
            g = ready.pop()
            seen += 1
            for s in succs[id(g)]:
                indeg[id(s)] -= 1
                if indeg[id(s)] == 0:
                    ready.append(s)
        if seen == len(groups):
            return None
        for g in groups:
            if indeg[id(g)] > 0 and len(g.nodes) > 1:
                return g
        raise AssertionError("cycle among single-node groups — invalid DAG")

    @staticmethod
    def _single(nd: DagNode) -> StageIR:
        if nd.op.kind == OpKind.REDUCE and nd.op.ef is not None:
            # lone error-feedback reduce (its DELIVERED sibling was DCE'd)
            return StageIR("ef_allreduce", (nd,), nd.inputs, (nd.out,),
                           axis=_stage_axis(nd))
        kind = _SINGLE_KINDS.get(nd.op.kind)
        if nd.op.kind == OpKind.REDUCE \
                and (nd.op.name or "").startswith("batched_ring"):
            # Coalesce-merged same-axis ring batch: same lowering as a
            # plain allreduce, but a distinct stage kind so the executor
            # can prioritize it and the cost model can amortize launches
            kind = "batched_allreduce"
        if kind is None:
            raise ValueError(f"cannot lower node {nd.op}")
        return StageIR(kind, (nd,), nd.inputs, (nd.out,),
                       axis=_stage_axis(nd))

    @staticmethod
    def _topo(groups: list[StageIR]) -> list[StageIR]:
        """Order groups so every consumed value is produced first (a
        cross-branch fusion like AR+A2A can capture a node defined after
        another group's root)."""
        produced_by = {v: g for g in groups for v in g.out_vids}
        ordered: list[StageIR] = []
        emitted: set[int] = set()

        def visit(g: StageIR):
            if id(g) in emitted:
                return
            emitted.add(id(g))
            for v in g.in_vids:
                dep = produced_by.get(v)
                if dep is not None:
                    visit(dep)
            ordered.append(g)

        for g in groups:
            visit(g)
        return ordered


# ---------------------------------------------------------------------------
# Pass 5: SelectSchedule — latency- vs bandwidth-optimal rings
# ---------------------------------------------------------------------------

_RESCHEDULABLE = {"allreduce", "map+allreduce", "batched_allreduce"}


class SelectSchedule:
    """Annotate all-reduce stages with the ring schedule to emit.

    Per-rank payload bytes are propagated from ``ctx.in_avals`` through the
    DAG; a stage whose payload is below ``CollectiveConfig.
    latency_optimal_below`` gets the (n-1)-hop full-message latency ring,
    larger ones the chunked RS∘AG bandwidth ring.  The analytic model in
    :mod:`repro_torch.core.netmodel` supplies predicted times (recorded in the
    stage desc) and the crossover when no explicit threshold is
    configured — both evaluated against the link tier of the *stage's own
    axis* (fast intra-pod ICI vs thin inter-pod DCI), so an outer-axis
    stage is costed on the wire it actually traverses.
    """

    name = "select_schedule"

    def run(self, groups: list[StageIR],
            ctx: CompileContext) -> list[StageIR]:
        nbytes = self._value_bytes(ctx)
        out: list[StageIR] = []
        for g in groups:
            # every stage records its raw per-rank payload (the program
            # cost model walks the emitted plan stage by stage)
            b = self._group_bytes(g, nbytes)
            if g.kind not in _RESCHEDULABLE:
                parts = None
                if g.kind == "allreduce+alltoall" and nbytes is not None:
                    # the shared ring carries the pair asymmetrically
                    # (histogram rides every hop whole, keys chunked) —
                    # keep the per-operand split for the cost model
                    vals = [nbytes.get(v) for v in g.in_vids]
                    if all(v is not None for v in vals):
                        parts = tuple(vals)
                if b is not None or parts is not None:
                    out.append(dataclasses.replace(g, bytes_in=b,
                                                   bytes_parts=parts))
                else:
                    out.append(g)
                continue
            red = next(nd for nd in g.nodes
                       if nd.op.kind in (OpKind.REDUCE,
                                         OpKind.REDUCE_SCATTER))
            if red.op.codec.combine_encoded is not None:
                # the encoded-domain combine only exists as the chunked
                # RS∘AG walk — there is no latency-ring variant to pick
                out.append(dataclasses.replace(
                    g, bytes_in=b, schedule="bandwidth",
                    desc=f"encoded-domain ({red.op.codec.name}) RS∘AG walk "
                         "(fixed schedule)"))
                continue
            wire = None
            if b is not None:
                # what actually travels: the sunk codec shrinks the wire
                wire = int(b * red.op.codec.wire_ratio)
            out.append(dataclasses.replace(
                g, bytes_in=b,
                **self._decide(wire, ctx, g.axis or ctx.axis_name)))
        return out

    @staticmethod
    def _group_bytes(g: StageIR, nbytes: Optional[dict]) -> Optional[int]:
        if nbytes is None or not g.in_vids:
            return None
        if g.kind == "allreduce+alltoall":
            # the fused-pair model takes the summed per-rank payload
            vals = [nbytes.get(v) for v in g.in_vids]
            return sum(vals) if all(v is not None for v in vals) else None
        if g.kind == "map":
            # a map streams what it *produces* (a Coalesce split is
            # address steering — it reads one slice of the bucket, not
            # the whole buffer; a pack's output is the sum of its inputs)
            b = nbytes.get(g.out_vids[0])
            if b is not None:
                return b
        return nbytes.get(g.in_vids[0])

    def _decide(self, payload: Optional[int], ctx: CompileContext,
                axis: str) -> dict:
        if payload is None:
            return {"schedule": "bandwidth",
                    "desc": "RS∘AG ring (payload unknown; "
                            "bandwidth-optimal default)"}
        n = ctx.size_of(axis)
        if n is None:
            # never cost one axis with another's ring size — without this
            # axis's size the model has nothing to say
            return {"schedule": "bandwidth",
                    "desc": f"[{axis}] RS∘AG ring (axis size unknown; "
                            "bandwidth-optimal default)"}
        net = ctx.net_of(axis)
        threshold = ctx.latency_optimal_below
        if threshold is None:
            threshold = netmodel.ring_crossover_bytes(n, net)
        t_lat = netmodel.ring_allreduce_time(n, payload, net,
                                             latency_optimal=True)
        t_bw = netmodel.ring_allreduce_time(n, payload, net,
                                            latency_optimal=False)
        sched = "latency" if payload < threshold else "bandwidth"
        return {"schedule": sched,
                "desc": f"[{axis}] {payload}B/rank vs threshold "
                        f"{threshold}B → {sched}-optimal ring "
                        f"(model: lat {t_lat * 1e6:.1f}us, "
                        f"bw {t_bw * 1e6:.1f}us)"}

    @staticmethod
    def _value_bytes(ctx: CompileContext) -> Optional[dict[int, int]]:
        """Per-rank payload bytes for every DAG value, or None if unknown.

        Exact where the aval propagation can see (meta-tensor evaluation
        sizes MAP bodies, including the Coalesce pack/split shims, whose
        outputs are nothing like their first input).  Where it cannot,
        a multi-input MAP falls back
        to the max over its *known* input sizes, and stays unknown when
        none are known — sizing it from ``inputs[0]`` alone would let a
        small first operand mis-drive the latency/bandwidth decision
        downstream.  AG/RS scale by the size of their own axis (unknown
        axis size → unknown output).
        """
        if ctx.in_avals is None:
            return None
        avals = _propagate_avals(ctx.dag, ctx)
        nbytes: dict[int, int] = {}
        for i, aval in enumerate(ctx.in_avals):
            size = int(math.prod(aval.shape)) if aval.shape else 1
            nbytes[i] = size * aval.dtype.itemsize
        for nd in ctx.dag.nodes:
            a = avals.get(nd.out)
            if a is not None:
                nbytes[nd.out] = _aval_bytes(a)
                continue
            k = nd.op.kind
            if k == OpKind.MAP:
                known = [nbytes[v] for v in nd.inputs if v in nbytes]
                if known:
                    nbytes[nd.out] = max(known)
                continue
            src = nbytes.get(nd.inputs[0])
            if src is None:
                continue
            if k == OpKind.ALLGATHER:
                n = SelectSchedule._axis_size(nd, ctx)
                if n is not None:
                    nbytes[nd.out] = src * n
            elif k == OpKind.REDUCE_SCATTER:
                n = SelectSchedule._axis_size(nd, ctx)
                if n is not None:
                    nbytes[nd.out] = max(src // n, 1)
            else:                       # REDUCE/A2A/SCAN/BCAST/DELIVERED
                nbytes[nd.out] = src    # (WIRE nodes are gone by Legalize)
        return nbytes

    @staticmethod
    def _axis_size(nd: DagNode, ctx: CompileContext) -> Optional[int]:
        """Size of the axis this node communicates over; axis=None means
        the program default (a pipeline without LowerTopology)."""
        ax = nd.op.axis
        if ax is None:
            ax = ctx.axis_name
        if not isinstance(ax, str) or ax == AUTO_AXIS:
            return None
        return ctx.size_of(ax)


# ---------------------------------------------------------------------------
# Pass 6: Emit
# ---------------------------------------------------------------------------

def _use_kernels(ctx: CompileContext) -> bool:
    return bool(getattr(ctx.config, "use_kernels", False))


def _hop_combine_kernel(monoid) -> Optional[Callable]:
    """The registered CUDA combine for a Type 1 monoid, as a ring
    ``hop_combine(incoming, local)`` hook; None when the monoid has no
    kernel (the ring then folds with the plain monoid combine)."""
    if monoid.name not in ("add", "max", "min"):
        return None
    sop = switchops.get(monoid.name)

    def hop(incoming, local, _sop=sop):
        return _sop(incoming, local, use_kernel=True)
    return hop


class Emit:
    """Lower every StageIR to a rank-local callable.

    Coalesce bucket packs additionally get an **arena slot**: the
    emitted run accepts an optional persistent flat buffer and writes
    the leaves into it in place instead of concatenating into a fresh
    one, so the pack's transient memory is ~1× the bucket, not 2×.
    """

    name = "emit"

    def run(self, groups: list[StageIR], ctx: CompileContext) -> list[Stage]:
        if _use_kernels(ctx):
            # bind the CUDA kernels onto the registry once so the
            # emitted closures' `use_kernel=True` calls actually hit them
            switchops.load_kernels()
        stages = []
        n_arenas = 0
        for g in groups:
            st = self._emit(g, ctx)
            if st.arena_aval is not None:
                st = dataclasses.replace(st, arena_slot=n_arenas)
                n_arenas += 1
            stages.append(st)
        if stages:
            _obs.RECORDER.count(
                "emit.kernel_stage" if _use_kernels(ctx)
                else "emit.reference_stage", len(stages))
        return stages

    def _emit(self, g: StageIR, ctx: CompileContext) -> Stage:
        run = getattr(self, "_" + g.kind.replace("+", "_"))(g, ctx)
        axis = g.axis
        if not axis:
            coll = [nd.op for nd in g.nodes
                    if nd.op.kind in COLLECTIVE_KINDS]
            if any(op.axis is not None for op in coll):
                # "auto"/tuple survived to Emit — running it over the
                # default axis would silently compute the wrong reduction
                raise ValueError(
                    f"stage {g.kind} has an unresolved compound axis "
                    f"{[op.axis for op in coll]}; include LowerTopology "
                    "in the pipeline")
            if coll:
                # a custom pipeline without LowerTopology leaves axis=None
                # ops unresolved — fall back to the program-wide default
                # axis (pure-map stages legitimately stay axis-less)
                axis = ctx.axis_name
        aval = None
        if g.kind == "map":
            sizes = getattr(g.nodes[0].op.fn, "bucket_sizes", None)
            if sizes is not None:
                aval = TensorSpec(
                    (sum(sizes),),
                    getattr(g.nodes[0].op.fn, "bucket_dtype", "float32"))
        return Stage(g.kind, run, g.desc, g.in_vids, g.out_vids, g.schedule,
                     axis, g.placement, g, arena_aval=aval)

    # -- fused stages --------------------------------------------------------

    @staticmethod
    def _waiting(kind: str, source: str):
        def run(args, ax):
            raise NotImplementedError(
                f"stage {kind!r} lowers through {source}, not ported yet")
        return run

    @staticmethod
    def _scan_allgather(g: StageIR, ctx: CompileContext):
        return Emit._waiting(g.kind, _WAITS_FUSED)

    @staticmethod
    def _allreduce_alltoall(g: StageIR, ctx: CompileContext):
        return Emit._waiting(g.kind, _WAITS_FUSED)

    @staticmethod
    def _map_allreduce(g: StageIR, ctx: CompileContext):
        mp, red = g.nodes[0].op, g.nodes[1].op
        lat = g.schedule == "latency"

        def run(args, ax, _f=mp.fn, _m=red.monoid, _c=red.codec, _l=lat):
            (x,) = args
            return (collectives.all_reduce(_f(x), ax, _m, codec=_c,
                                           latency_optimal=_l),)
        return run

    @staticmethod
    def _map_reduce_scatter(g: StageIR, ctx: CompileContext):
        return Emit._waiting(g.kind, _WAITS_FUSED)

    @staticmethod
    def _allgather_map(g: StageIR, ctx: CompileContext):
        return Emit._waiting(g.kind, _WAITS_FUSED)

    @staticmethod
    def _ef_allreduce(g: StageIR, ctx: CompileContext):
        return Emit._waiting(g.kind, _WAITS_LOOKASIDE)

    @staticmethod
    def _delivered(g: StageIR, ctx: CompileContext):
        return Emit._waiting(g.kind, _WAITS_LOOKASIDE)

    # -- single-node lowerings ----------------------------------------------

    @staticmethod
    def _map(g: StageIR, ctx: CompileContext):
        op = g.nodes[0].op
        sizes = getattr(op.fn, "bucket_sizes", None)
        if sizes is None:
            def run(args, ax, _f=op.fn):
                return (_f(*args),)
            return run

        # Coalesce bucket pack: without an arena, the plain concat; with
        # one, flatten every leaf into the persistent buffer in place —
        # the same layout, written into the caller's tensor.  With kernels
        # on, the N per-leaf copies collapse into ONE pack launch
        # (switchops "pack_combine").  A masked pack (``masked_monoid``
        # set) masks its leaves with the monoid identity *before* the
        # in-place writes and stores the alive flag in the trailing count
        # lane — same layout, same arena, one extra element.
        uk = _use_kernels(ctx)
        masked = getattr(op.fn, "masked_monoid", None)

        def run(args, ax, arena=None, _f=op.fn, _sizes=sizes, _uk=uk,
                _m=masked):
            if arena is None:
                return (_f(*args),)
            _check_pack_sizes(args, _sizes)
            tp = current()
            parts = [tp.flatten_local(x).to(arena.dtype) for x in args]
            if _m is not None:
                alive = parts[-1]
                live = tp.rank_bcast(alive[..., 0] != 0, parts[0])
                parts = [torch.where(live, p, _m.identity(TensorSpec(
                    tuple(p.shape), arena.dtype, arena.device)))
                    for p in parts[:-1]] + [alive]
            if _uk:
                parts = [p.contiguous() for p in parts]
                return (switchops.get("pack_combine")(
                    arena, *parts, use_kernel=True),)
            off = 0
            for p, s in zip(parts, _sizes):
                arena[..., off:off + s].copy_(p)
                off += s
            return (arena,)
        return run

    @staticmethod
    def _allreduce(g: StageIR, ctx: CompileContext):
        op = g.nodes[-1].op if g.nodes[-1].op.kind == OpKind.REDUCE \
            else g.nodes[0].op           # RS∘AG group: monoid/codec on RS
        lat = g.schedule == "latency"
        hop = _hop_combine_kernel(op.monoid) if _use_kernels(ctx) else None

        def run(args, ax, _m=op.monoid, _c=op.codec, _l=lat, _h=hop):
            (x,) = args
            return (collectives.all_reduce(x, ax, _m, codec=_c,
                                           latency_optimal=_l,
                                           hop_combine=_h),)
        return run

    # batched same-axis ring: k independent allreduces already merged into
    # one chunk-aligned stacked buffer by Coalesce — the lowering is the
    # plain allreduce of that buffer
    _batched_allreduce = _allreduce

    @staticmethod
    def _reduce_scatter(g: StageIR, ctx: CompileContext):
        op = g.nodes[0].op
        hop = _hop_combine_kernel(op.monoid) if _use_kernels(ctx) else None

        def run(args, ax, _m=op.monoid, _c=op.codec, _h=hop):
            (x,) = args
            return (collectives.reduce_scatter(x, ax, _m, codec=_c,
                                               hop_combine=_h),)
        return run

    @staticmethod
    def _allgather(g: StageIR, ctx: CompileContext):
        def run(args, ax):
            (x,) = args
            return (collectives.all_gather(x, ax),)
        return run

    @staticmethod
    def _alltoall(g: StageIR, ctx: CompileContext):
        def run(args, ax):
            (x,) = args
            return (collectives.all_to_all(x, ax),)
        return run

    @staticmethod
    def _scan(g: StageIR, ctx: CompileContext):
        op = g.nodes[0].op

        def run(args, ax, _m=op.monoid, _e=op.exclusive):
            (x,) = args
            return (collectives.prefix_scan(x, ax, _m, exclusive=_e),)
        return run

    @staticmethod
    def _bcast(g: StageIR, ctx: CompileContext):
        op = g.nodes[0].op

        def run(args, ax, _r=op.root):
            (x,) = args
            return (collectives.broadcast(x, ax, _r),)
        return run


# ---------------------------------------------------------------------------
# The pipeline & public entry points
# ---------------------------------------------------------------------------

DEFAULT_PIPELINE = (Legalize(), LowerTopology(), Coalesce(), FuseHops(),
                    SelectSchedule(), Emit())


def run_pipeline(dag: DagProgram, ctx: CompileContext,
                 pipeline=DEFAULT_PIPELINE):
    ctx.dag = dag                       # Legalize may rewrite; keep current
    unit: Any = dag
    for p in pipeline:
        unit = p.run(unit, ctx)
        if isinstance(unit, DagProgram):
            ctx.dag = unit
    return unit, ctx.dag


def compile_rank_local(
    prog: ProgramLike,
    axis_name: str,
    *,
    axis_size: Optional[int] = None,
    config: Any = None,
    in_avals: Optional[Sequence[Any]] = None,
    topology: Optional[Topology] = None,
    pipeline=DEFAULT_PIPELINE,
) -> CompiledProgram:
    """Compile to a rank-local callable (run it inside ``with mesh:`` on
    rank-stacked tensors, e.g. embedded in a train step).

    ``prog`` may be a traced :class:`DagProgram`, a legacy chain
    :class:`SwitchProgram`, or a plain function (traced on the fly).
    ``axis_name`` is the default axis for ops that don't name one;
    ``topology`` describes all DP axes (it defaults to the single
    ``axis_name`` axis) and drives the LowerTopology pass.
    """
    dag = _as_dag(prog)
    if topology is None:
        topology = Topology.single(axis_name, axis_size)
    ctx = CompileContext(axis_name=axis_name, axis_size=axis_size,
                         config=config, in_avals=in_avals,
                         topology=topology)
    stages, final_dag = run_pipeline(dag, ctx, pipeline)
    out = CompiledProgram(stages, final_dag, topology=ctx.topology)
    rec = _obs.RECORDER
    if rec.enabled:
        rec.count("compile.programs")
        for st in stages:
            nb = getattr(st.ir, "bytes_in", None) if st.ir is not None \
                else None
            if nb:
                rec.observe("plan.stage_bytes", float(nb))
            if st.placement is not None:
                rec.count("cgra.placed" if st.placement.fits
                          else "cgra.host_fallback")
        for grp in out.plan.waves:
            rec.observe("plan.wave_width", float(len(grp)))
    return out


def _to_ranks(x: torch.Tensor, spec, mesh: LocalMesh) -> torch.Tensor:
    """A global tensor → the rank-stacked tensor ``shard_map`` would hand
    the ranks under ``spec``: ``P("data")`` splits the leading dim over
    the ``data`` ranks (``[G, ...]`` → ``[data, G/data, ...]``), ``P(None)``
    / ``P()`` replicates.  One axis per spec in this slice."""
    x = torch.as_tensor(x, device=mesh.device)
    axis = _spec_axis(spec)
    if axis is None:
        return x.expand(mesh.rank_shape + tuple(x.shape)).contiguous()
    d, n = mesh.dim(axis), mesh.axis_size(axis)
    if x.shape[0] % n:
        raise ValueError(f"leading dim {x.shape[0]} not divisible by the "
                         f"{n} ranks of axis {axis!r}")
    y = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    y = y.reshape(tuple(n if j == d else 1 for j in range(mesh.rank_ndim))
                  + tuple(y.shape[1:]))
    return y.expand(mesh.rank_shape + tuple(y.shape[mesh.rank_ndim:])) \
        .contiguous()


def _from_ranks(y: torch.Tensor, spec, mesh: LocalMesh) -> torch.Tensor:
    """The inverse of :func:`_to_ranks`: concat the ``spec`` axis's ranks
    along the leading dim, or take rank 0's copy of a replicated value."""
    axis = _spec_axis(spec)
    if axis is None:
        return y[(0,) * mesh.rank_ndim]
    d = mesh.dim(axis)
    y = y[tuple(slice(None) if j == d else 0
                for j in range(mesh.rank_ndim))]
    return y.reshape((y.shape[0] * y.shape[1],) + tuple(y.shape[2:]))


def _spec_axis(spec) -> Optional[str]:
    entries = tuple(spec) if spec is not None else ()
    if any(e is not None for e in entries[1:]) \
            or (entries and not isinstance(entries[0], (str, type(None)))):
        raise NotImplementedError(
            f"partition spec {spec!r}: only the leading dim may be sharded, "
            "over one mesh axis (multi-axis specs wait for ROADMAP.md, "
            "queue 1 item 3)")
    return entries[0] if entries else None


def compile_program(
    prog: ProgramLike,
    mesh: LocalMesh,
    axis_name: str,
    in_specs,
    out_specs,
    *,
    config: Any = None,
    in_avals: Optional[Sequence[Any]] = None,
    topology: Optional[Topology] = None,
) -> Callable:
    """Emit the whole program as one callable on global tensors — the
    port's ``jit(shard_map(...))``: inputs are split over the mesh's ranks
    by ``in_specs``, the rank-local program runs eagerly inside the mesh,
    outputs are reassembled by ``out_specs``.  A single
    :class:`~repro_torch.mesh.PartitionSpec` applies to every argument."""
    sizes = dict(mesh.axes)
    axis_size = sizes[axis_name]
    if topology is not None:
        topology = topology.with_sizes(sizes)
    compiled = compile_rank_local(prog, axis_name, axis_size=axis_size,
                                  config=config, in_avals=in_avals,
                                  topology=topology)

    def run(*xs):
        ins = in_specs if not isinstance(in_specs, PartitionSpec) \
            else (in_specs,) * len(xs)
        with mesh:
            outs = compiled(*(_to_ranks(x, s, mesh)
                              for x, s in zip(xs, ins)))
            outs_sp = out_specs if not isinstance(out_specs, PartitionSpec) \
                else (out_specs,) * len(outs)
            res = tuple(_from_ranks(o, s, mesh)
                        for o, s in zip(outs, outs_sp))
        # the rank-local program always returns a tuple; like shard_map,
        # a single output comes back bare
        return res[0] if len(res) == 1 else res

    run.stages = compiled.stage_kinds()
    run.schedules = compiled.stage_schedules()
    run.axes = compiled.stage_axes()
    run.compiled = compiled
    return run
