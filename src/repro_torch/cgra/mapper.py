"""CGRA mapper — lower a stage's compute body onto the switch grid.

The PyTorch counterpart of :mod:`repro.cgra.mapper`.  The paper's §VI
toolchain: user source → dataflow graph → schedule / place onto the CGRA
→ binary.  The "user source" is whatever compute a compiled stage
carries — fused MAP bodies, the collective's monoid combine, a wire
codec's encoded-domain combine, a look-aside compressor — traced to a
flat ATen graph with ``torch.fx.experimental.proxy_tensor.make_fx``,
lowered to a small op-graph, and list-scheduled onto the
:class:`~repro_torch.cgra.device.CGRADevice` grid:

  * ASAP levels give the pipeline stages; level *l* places on grid row
    ``l % rows``, greedily left to right (spill rows fold into II).
  * ALU ops take one PE slot; accumulator ops take one PE plus
    ``log2(extent)`` pipeline depth (a balanced combine tree); steering
    ops (views, expands, slices, concatenation, constants) are absorbed
    by the interconnect.
  * An explicit table (:data:`ATEN_OPS`) names each ATen overload by the
    device's vocabulary (the reference's primitive names), so a
    placement's ``ops`` read as the reference's.  Anything outside it —
    ``topk``/``sort`` (no sort network), ``mm`` (no MAC array),
    ``index``/``index_put`` (random access), a higher-order ``cond`` or
    ``scan`` (no sequential controller) — does not fit, and the stage
    gets an explicit :class:`HostFallback` naming the op.  So does a body
    ``make_fx`` cannot trace (a data-dependent branch, an opaque call).

Tracing binds the topology's axes as the reference's ``vmap`` frames do:
the body runs inside a :class:`~repro_torch.mesh.LocalMesh` on the
``meta`` device with the compile topology's axis sizes (2 where a size is
unknown), on inputs that carry those rank dims — so rank-local
bookkeeping such as ``axis_size`` traces, and no data is made.  A body
that *communicates* (a roll along a rank dim) is caught by the same
unsupported-op check: a collective inside a MAP body is endpoint code.

What gets traced are the plain bodies.  A hand-written kernel is a fast
implementation of a body the mapper prices, never what is placed.

:class:`~repro_torch.core.compiler.PlaceCGRA` is the compiler pass
(after SelectSchedule, before Emit) that attaches a placement — or
fallback — to every stage through :func:`place_groups`.
"""

from __future__ import annotations

import dataclasses
import math
import operator
from typing import Callable, Optional, Sequence

import torch

from repro_torch.cgra.device import (ACCUM_PRIMS, ALU_PRIMS, CGRADevice,
                                     HostFallback, PAPER_CGRA, Placement,
                                     route_through)
from repro_torch.core import netmodel
from repro_torch.core.program import COLLECTIVE_KINDS, OpKind
from repro_torch.core.types import TensorSpec
from repro_torch.core.wire import IDENTITY
from repro_torch.mesh import LocalMesh, Unranked

# Stand-in rank-local aval when the compiler was given none: elementwise
# op-graphs are shape-independent, so a small one recovers the structure.
_FALLBACK_AVAL = TensorSpec((64,), torch.float32)


# ---------------------------------------------------------------------------
# the ATen → device vocabulary table
# ---------------------------------------------------------------------------

_ALU = {
    "add": "add", "sub": "sub", "rsub": "sub", "mul": "mul", "div": "div",
    "true_divide": "div", "remainder": "rem", "fmod": "rem", "neg": "neg",
    "maximum": "max", "minimum": "min", "fmax": "max", "fmin": "min",
    "clamp_min": "max", "clamp_max": "min", "clamp": "clamp",
    "abs": "abs", "sign": "sign", "sgn": "sign", "floor": "floor",
    "ceil": "ceil", "round": "round", "nextafter": "nextafter",
    "exp": "exp", "exp2": "exp2", "log": "log", "log1p": "log1p",
    "expm1": "expm1", "sigmoid": "logistic", "tanh": "tanh",
    "sqrt": "sqrt", "rsqrt": "rsqrt", "square": "square", "pow": "pow",
    "sin": "sin", "cos": "cos", "erf": "erf", "erfc": "erfc",
    "erfinv": "erf_inv",
    "lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq", "ne": "ne",
    "where": "select_n",
    "logical_and": "and", "bitwise_and": "and", "logical_or": "or",
    "bitwise_or": "or", "logical_xor": "xor", "bitwise_xor": "xor",
    "logical_not": "not", "bitwise_not": "not",
    "bitwise_left_shift": "shift_left",
    "bitwise_right_shift": "shift_right_arithmetic",
    "isfinite": "is_finite", "real": "real", "imag": "imag",
    "detach": "stop_gradient",
}

_ACCUM = {
    "sum": "reduce_sum", "amax": "reduce_max", "amin": "reduce_min",
    "max": "reduce_max", "min": "reduce_min", "prod": "reduce_prod",
    "all": "reduce_and", "any": "reduce_or", "cumsum": "cumsum",
    "cumprod": "cumprod", "cummax": "cummax", "cummin": "cummin",
    "logcumsumexp": "cumlogsumexp", "argmax": "argmax", "argmin": "argmin",
}

# data steering the interconnect absorbs (the reference's ROUTE_PRIMS):
# views, broadcasts, static slices, concatenation and constants
_ROUTE = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_copy", "broadcast_to", "unsqueeze", "squeeze", "permute",
    "transpose", "t", "slice", "select", "narrow", "cat", "stack", "split",
    "split_with_sizes", "chunk", "unbind", "flip", "constant_pad_nd",
    "pad", "full", "full_like", "zeros", "zeros_like", "ones", "ones_like",
    "empty", "empty_like", "empty_strided", "new_zeros", "new_ones",
    "new_full", "new_empty", "scalar_tensor", "arange", "clone", "alias",
    "lift_fresh_copy", "contiguous", "copy", "copy_", "fill", "fill_",
    "zero_", "_to_copy", "to", "flatten", "unflatten", "repeat",
})

# the full table, one entry per ATen op name: (class, vocabulary name)
ATEN_OPS: dict = {**{k: ("alu", v) for k, v in _ALU.items()},
                  **{k: ("accum", v) for k, v in _ACCUM.items()},
                  **{k: ("route", k) for k in _ROUTE}}

# reshapes that keep their operand's shape move nothing (a jaxpr has no
# equation for them; an ATen graph records the view)
_SHAPE_VIEWS = frozenset({"view", "_unsafe_view", "reshape", "_reshape_alias",
                          "expand", "alias", "flatten", "unflatten"})


class _Unsupported(Exception):
    def __init__(self, prim: str):
        super().__init__(prim)
        self.prim = prim


# ---------------------------------------------------------------------------
# ATen graph → op-graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpGraph:
    """Flattened compute body: op names with ASAP levels."""

    ops: tuple            # (name, level) for ALU/accumulator ops
    n_route: int
    depth: int            # pipeline depth incl. accumulator trees

    @property
    def n_ops(self) -> int:
        return len(self.ops)


def _val(a):
    return a.meta.get("val") if isinstance(a, torch.fx.Node) else a


def _reduced_extent(node) -> int:
    """Elements folded by an accumulator op (for tree depth): the largest
    dim of its input, as the reference reads its operand's aval."""
    try:
        shape = tuple(_val(node.args[0]).shape) or (1,)
        return max(int(max(shape)), 2)
    except (AttributeError, IndexError, TypeError):
        return 2


def _same_shape(node) -> bool:
    try:
        return tuple(_val(node.args[0]).shape) == tuple(_val(node).shape)
    except (AttributeError, IndexError, TypeError):
        return False


def _classify(node) -> tuple[str, str]:
    """``(class, vocabulary name)`` of one ATen call; raises
    :class:`_Unsupported` outside the table."""
    target = node.target
    packet = getattr(target, "overloadpacket", None)
    qual = str(packet) if packet is not None else str(target)
    base = qual.rsplit(".", 1)[-1]
    if base not in ATEN_OPS and base.endswith("_"):
        base = base[:-1]                    # an in-place form
    if base in ("max", "min") and len(node.args) > 1 \
            and isinstance(node.args[1], torch.fx.Node):
        return "alu", base          # elementwise over two tensors
    if base == "_to_copy":
        src, dt = _val(node.args[0]), node.kwargs.get("dtype")
        if dt is not None and getattr(src, "dtype", dt) != dt:
            return "alu", "convert_element_type"
        return "route", "copy"
    if base == "pow" and len(node.args) > 1 \
            and isinstance(node.args[1], int):
        # jnp.square is its own primitive; other integer powers are one
        return "alu", "square" if node.args[1] == 2 else "integer_pow"
    got = ATEN_OPS.get(base)
    if got is None:
        raise _Unsupported(qual)
    return got


def lower_graph(gm: torch.fx.GraphModule,
                supported: frozenset = ALU_PRIMS) -> OpGraph:
    """Lower a ``make_fx`` graph to an :class:`OpGraph`.

    ``supported`` is the target device's ALU vocabulary
    (:attr:`CGRADevice.supported`) — raises :class:`_Unsupported` on the
    first op outside it (or outside the accumulator/steering classes)."""
    levels: dict = {}
    ops: list = []
    n_route = 0

    def level_of(args) -> int:
        lv = 0
        for a in args:
            if isinstance(a, (list, tuple)):
                lv = max(lv, level_of(a))
            elif isinstance(a, torch.fx.Node):
                lv = max(lv, levels.get(a, 0))
        return lv

    for node in gm.graph.nodes:
        if node.op != "call_function":
            levels[node] = 0                # inputs, constants, output
            continue
        lvl = level_of(list(node.args) + list(node.kwargs.values()))
        if node.target is operator.getitem:
            levels[node] = lvl              # one output of a multi-output op
            continue
        cls, name = _classify(node)
        if cls == "route":
            if not (name in _SHAPE_VIEWS and _same_shape(node)):
                n_route += 1
            levels[node] = lvl
        elif cls == "accum":
            if name not in ACCUM_PRIMS:
                raise _Unsupported(name)
            ops.append((name, lvl))
            levels[node] = lvl + int(math.ceil(math.log2(
                _reduced_extent(node))))
        else:
            if name not in supported:
                raise _Unsupported(name)
            ops.append((name, lvl))
            levels[node] = lvl + 1
    depth = max([lvl + 1 for _, lvl in ops], default=0)
    return OpGraph(tuple(ops), n_route, depth)


def _meta(aval, lead: tuple = ()) -> torch.Tensor:
    dtype = aval.dtype if isinstance(aval.dtype, torch.dtype) \
        else getattr(torch, str(aval.dtype))
    return torch.empty(lead + tuple(aval.shape), dtype=dtype, device="meta")


def trace_body(fn: Callable, avals: Sequence, axis_env: Optional[dict] = None,
               memo: Optional[dict] = None) -> torch.fx.GraphModule:
    """``make_fx`` of a stage body with the topology's axes bound.

    ``axis_env`` maps axis name → size (unknown sizes trace as 2); the
    body runs inside a ``LocalMesh`` of those axes on the ``meta`` device,
    on inputs that carry the rank dims in front of each aval's shape.
    ``memo`` (one PlaceCGRA run's) keeps each body's graph, so a MAP body
    is traced once for its output aval and its placement."""
    from torch.fx.experimental.proxy_tensor import make_fx

    axis_env = axis_env or {}
    if memo is not None:
        key = (id(fn), tuple((tuple(a.shape), str(a.dtype)) for a in avals),
               tuple(axis_env.items()))
        hit = memo.get(key)
        if hit is None:
            hit = memo[key] = (fn, trace_body(fn, avals, axis_env))
        return hit[1]
    mesh = LocalMesh({ax: int(n) if n else 2 for ax, n in axis_env.items()},
                     device="meta") if axis_env else Unranked()
    args = [_meta(a, mesh.rank_shape) for a in avals]
    with mesh:
        return make_fx(fn, tracing_mode="real")(*args)


# ---------------------------------------------------------------------------
# placement (list scheduling + greedy grid assignment)
# ---------------------------------------------------------------------------

def place_opgraph(graph: OpGraph, device: CGRADevice
                  ) -> "Placement | HostFallback":
    """Place a lowered op-graph onto the grid; the doesn't-fit outcomes
    are explicit so callers can cost the host detour."""
    if graph.n_ops == 0:
        if graph.n_route > device.route_budget:
            return HostFallback(
                f"{graph.n_route} steering ops exceed the routing budget "
                f"({device.route_budget})")
        return route_through(device, graph.n_route)
    if graph.n_ops > device.op_slots:
        return HostFallback(
            f"op graph needs {graph.n_ops} ALU slots, device has "
            f"{device.op_slots} ({device.n_pes} PEs x "
            f"{device.ops_per_pe} slots)")
    if graph.n_route > device.route_budget:
        return HostFallback(
            f"{graph.n_route} steering ops exceed the routing budget "
            f"({device.route_budget})")
    if graph.depth > device.max_depth:
        return HostFallback(
            f"pipeline depth {graph.depth} exceeds the register budget "
            f"({device.max_depth})")

    # Greedy level-major placement: level l starts on row l % rows and
    # claims columns left to right; a level wider than the row wraps to
    # the next row (still one spatial wave as long as PEs remain).
    occupied: list = []
    slot_use: dict = {}
    r = c = 0
    for prim, lvl in sorted(graph.ops, key=lambda o: o[1]):
        placed = False
        for _ in range(device.n_pes * device.ops_per_pe):
            pe = (r, c)
            if slot_use.get(pe, 0) < device.ops_per_pe:
                slot_use[pe] = slot_use.get(pe, 0) + 1
                if pe not in occupied:
                    occupied.append(pe)
                placed = True
                break
            c += 1
            if c == device.cols:
                c, r = 0, (r + 1) % device.rows
        if not placed:                             # pragma: no cover
            return HostFallback("placement overflow")
    ii = max(1, math.ceil(graph.n_ops / device.n_pes))
    return Placement(device=device, n_ops=graph.n_ops,
                     n_route=graph.n_route, depth=graph.depth, ii=ii,
                     pes=tuple(occupied),
                     ops=tuple(p for p, _ in sorted(graph.ops,
                                                    key=lambda o: o[1])))


# ---------------------------------------------------------------------------
# stage compute bodies
# ---------------------------------------------------------------------------

def _codec_combine_body(monoid, codec, aval) -> tuple[Callable, tuple]:
    """What one hop's aggregation unit actually computes for a reduce.

    For an encoded-domain codec, both operands arrive *already encoded*
    (the payload is coded once at injection, not per hop), so the hop
    body is ``combine_encoded`` alone over the encoded leaves — the plain
    combine, whose kernel the ring runs on the card."""
    if codec is IDENTITY:
        return monoid.combine, (aval, aval)
    if codec.combine_encoded is not None:
        with Unranked():
            enc = codec.encode(_meta(aval))
        leaves = list(enc) if isinstance(enc, (tuple, list)) else [enc]
        k = len(leaves)

        def body(*flat):
            a, b = tuple(flat[:k]), tuple(flat[k:])
            return codec.combine_encoded(a if k > 1 else a[0],
                                         b if k > 1 else b[0])

        avals = tuple(TensorSpec(tuple(l.shape), l.dtype) for l in leaves)
        return body, avals + avals
    # cast-style codec: hops combine in the wire dtype
    return (lambda a, b: monoid.combine(codec.encode(a), codec.encode(b)),
            (aval, aval))


def _int8_local_body(t):
    """Rank-local half of the shared-scale int8 compressor (the part the
    switch pipeline runs per payload block): blockwise absmax → scale →
    quantize → dequantize.  The tiny scale max-allreduce is network, not
    PE work."""
    from repro_torch.mesh import ambient

    block = 256
    tp = ambient()
    flat = tp.flatten_local(t).to(torch.float32)
    pad = (-flat.shape[-1]) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(flat.shape[:-1] + (pad,))],
                         dim=-1)
    blocks = flat.reshape(flat.shape[:-1] + (-1, block))
    absmax = blocks.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int16)
    return (q.to(torch.float32) * scale).reshape(flat.shape)


def _topk_local_body(t, ratio):
    from repro_torch.mesh import ambient

    flat = ambient().flatten_local(t)
    k = max(1, int(flat.shape[-1] * ratio))
    return torch.topk(flat.abs(), k)


def _ef_body(ef) -> tuple[Callable, str]:
    if ef.compressor in ("int8", "int8_hopquant"):
        return _int8_local_body, f"{ef.compressor} quantize pipeline"
    if ef.compressor == "topk":
        return (lambda t: _topk_local_body(t, ef.topk_ratio),
                "top-k sparsifier")
    return (lambda t: t), ef.compressor


def stage_bodies(stage_ir, aval_of: Callable[[int], TensorSpec]
                 ) -> list[tuple[Callable, tuple, str]]:
    """The compute bodies one stage streams through the array.

    Returns ``[(fn, avals, label), ...]`` — fused stages contribute one
    body per compute-carrying node (a map fused into a reduce means the
    pipe runs map *then* combine on every word-group)."""
    bodies: list = []
    for nd in stage_ir.nodes:
        op = nd.op
        if op.kind == OpKind.MAP:
            avals = tuple(aval_of(v) for v in nd.inputs)
            bodies.append((op.fn, avals, f"map:{op.name or 'fn'}"))
        elif op.kind in (OpKind.REDUCE, OpKind.REDUCE_SCATTER, OpKind.SCAN):
            aval = aval_of(nd.inputs[0])
            if op.ef is not None:
                fn, label = _ef_body(op.ef)
                bodies.append((fn, (aval,), label))
            else:
                label = f"{op.monoid.name}-combine"
                if op.codec is not IDENTITY:
                    label += f"@{op.codec.name}"
                try:
                    fn, avals = _codec_combine_body(op.monoid, op.codec,
                                                    aval)
                except Exception as e:
                    return [((lambda: None), (), f"{label}: uncodable "
                             f"({type(e).__name__})")]
                bodies.append((fn, avals, label))
        elif op.kind == OpKind.DELIVERED and op.ef is not None:
            # in a fused REDUCE+DELIVERED pair the compression runs once
            # and yields both outputs — don't double-count the pipeline
            paired = any(o.op.kind == OpKind.REDUCE and o.op.ef == op.ef
                         for o in stage_ir.nodes)
            if not paired:
                fn, label = _ef_body(op.ef)
                bodies.append((fn, (aval_of(nd.inputs[0]),), label))
        # movement kinds carry no ALU body
    return bodies


def place_stage(stage_ir, device: CGRADevice,
                aval_of: Callable[[int], TensorSpec],
                axis_env: Optional[dict] = None,
                memo: Optional[dict] = None
                ) -> "Placement | HostFallback":
    """Map one fused stage's full compute body onto the device.

    Multiple bodies (map ∘ combine) chain in the pipe: op slots add,
    depths add.  No body at all is pure movement — a route-through."""
    bodies = stage_bodies(stage_ir, aval_of)
    if not bodies:
        return route_through(device,
                             note="forwarding/replication, no PE compute")
    ops: list = []
    n_route = 0
    depth = 0
    for fn, avals, label in bodies:
        try:
            gm = trace_body(fn, avals, axis_env, memo)
        except Exception as e:
            return HostFallback(
                f"{label}: body is not a rank-local dataflow graph "
                f"({type(e).__name__}: {e})"[:300])
        try:
            g = lower_graph(gm, device.supported)
        except _Unsupported as e:
            return HostFallback(f"{label}: primitive {e.prim!r} "
                                "not implemented by the switch CGRA")
        ops.extend((p, lvl + depth) for p, lvl in g.ops)
        n_route += g.n_route
        depth += g.depth
    return place_opgraph(OpGraph(tuple(ops), n_route, depth), device)


# ---------------------------------------------------------------------------
# place_groups — the body of the compiler's PlaceCGRA pass
# ---------------------------------------------------------------------------

def place_groups(groups: list, ctx,
                 device: Optional[CGRADevice] = None) -> list:
    """Attach a CGRA placement (or host fallback) to every stage group.

    Called by :class:`repro_torch.core.compiler.PlaceCGRA` (which defers
    the import of this module so the two stay import-acyclic)."""
    device = device \
        or getattr(ctx.config, "cgra_device", None) or PAPER_CGRA
    memo: dict = {}
    avals = _value_avals(ctx, memo)

    def aval_of(vid: int) -> TensorSpec:
        return avals.get(vid, _FALLBACK_AVAL)

    axis_env = _axis_env(ctx)
    out = []
    for g in groups:
        pl = place_stage(g, device, aval_of, axis_env, memo)
        desc = g.desc
        t = _stage_model_time(g, pl, ctx, avals)
        note = pl.describe() + (f"; model {t * 1e6:.1f}us"
                                if t is not None else "")
        desc = f"{desc} | {note}" if desc else note
        out.append(dataclasses.replace(g, placement=pl, desc=desc))
    return out


def _axis_env(ctx) -> dict:
    env: dict = {}
    topo = getattr(ctx, "topology", None)
    if topo is not None:
        for a in topo.axes:
            env[a.name] = a.size or 2
    elif getattr(ctx, "axis_name", None):
        env[ctx.axis_name] = getattr(ctx, "axis_size", None) or 2
    return env


def _value_avals(ctx, memo: Optional[dict] = None) -> dict:
    """Best-effort rank-local avals for every DAG value (shapes drive
    body tracing; sizes drive the model re-cost).  Mirrors
    SelectSchedule's byte propagation, but in shape space, with the
    topology's axes bound."""
    if ctx.in_avals is None or ctx.dag is None:
        return {}
    avals: dict = {i: TensorSpec(tuple(a.shape), a.dtype)
                   for i, a in enumerate(ctx.in_avals)}
    axis_env = _axis_env(ctx)
    lead = len(axis_env)
    for nd in ctx.dag.nodes:
        k = nd.op.kind
        ins = [avals.get(v) for v in nd.inputs]
        if k == OpKind.MAP:
            if any(a is None for a in ins):
                continue
            try:
                gm = trace_body(nd.op.fn, ins, axis_env, memo)
                out = [n for n in gm.graph.nodes if n.op == "output"][0]
                res = out.args[0]
                first = res[0] if isinstance(res, (tuple, list)) else res
                v = _val(first)
                avals[nd.out] = TensorSpec(tuple(v.shape[lead:]), v.dtype)
            except Exception:
                pass
            continue
        if ins and ins[0] is not None:
            src = ins[0]
            ax = nd.op.axis if isinstance(nd.op.axis, str) else None
            n = axis_env.get(ax or getattr(ctx, "axis_name", ""), None)
            if k == OpKind.ALLGATHER and n and src.shape:
                avals[nd.out] = TensorSpec(
                    (src.shape[0] * n,) + tuple(src.shape[1:]), src.dtype)
            elif k == OpKind.REDUCE_SCATTER and n and src.shape:
                avals[nd.out] = TensorSpec(
                    (max(src.shape[0] // n, 1),) + tuple(src.shape[1:]),
                    src.dtype)
            else:
                avals[nd.out] = src
    return avals


def _itemsize(dtype) -> int:
    dt = dtype if isinstance(dtype, torch.dtype) \
        else getattr(torch, str(dtype))
    return dt.itemsize


def _stage_model_time(g, placement, ctx, avals) -> Optional[float]:
    """Analytic stage time with the placement-derived rate (None when
    the payload is unknown)."""
    aval = avals.get(g.in_vids[0]) if g.in_vids else None
    if aval is None:
        return None
    m = int(math.prod(aval.shape or (1,))) * _itemsize(aval.dtype)
    axis = g.axis or getattr(ctx, "axis_name", "")
    n = ctx.size_of(axis) if axis else None
    p = ctx.net_of(axis) if axis else getattr(ctx, "net", netmodel.PAPER)
    try:
        return netmodel.stage_time(g.kind, n or 1, m, p,
                                   placement=placement,
                                   schedule=g.schedule,
                                   codec_ratio=_codec_ratio(g))
    except Exception:
        return None


def _codec_ratio(g) -> float:
    for nd in g.nodes:
        if nd.op.kind in COLLECTIVE_KINDS and nd.op.codec is not IDENTITY:
            return float(nd.op.codec.wire_ratio)
    return 1.0


__all__ = ["ATEN_OPS", "OpGraph", "lower_graph", "trace_body",
           "place_opgraph", "stage_bodies", "place_stage", "place_groups"]
