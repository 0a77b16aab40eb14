"""CGRA device model — the paper's §IV modular switch extension.

The switch's processing module is a coarse-grained reconfigurable array:
a small grid of processing elements (PEs) on the data path between the
ingress parser and the egress scheduler.  Payload words stream through
the array at line granularity; the mapped op-graph is a *spatial
pipeline* (one PE per op, level by level), so throughput is one input
word-group per initiation interval (II) once the pipe is full.

This module is deliberately standalone (no imports from ``repro_torch.core``):
:mod:`repro_torch.core.netmodel` derives its in-switch compute rates from a
:class:`CGRADevice` + :class:`Placement` instead of the old
``accel_clock``/``accel_width`` magic constants, and the mapper
(:mod:`repro_torch.cgra.mapper`) produces the placements.

Feasibility is the point: an op-graph that needs more PE slots, more
pipeline depth, or primitives the array doesn't implement gets an
explicit :class:`HostFallback` — the framework then *costs that stage as
a PCIe + MPI host detour* rather than silently pretending the switch ran
it (the honesty ACCL+/FPsPIN-style device models buy).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


# Primitive vocabulary of one PE's ALU.  Names are jax primitive names —
# the mapper lowers a stage's compute body to a jaxpr and classifies
# every equation against these sets.
ALU_PRIMS = frozenset({
    "add", "sub", "mul", "div", "rem", "neg", "max", "min",
    "abs", "sign", "floor", "ceil", "round", "clamp", "nextafter",
    "exp", "exp2", "log", "log1p", "expm1", "logistic", "tanh",
    "sqrt", "rsqrt", "cbrt", "square", "integer_pow", "pow",
    "sin", "cos", "erf", "erfc", "erf_inv",
    "lt", "le", "gt", "ge", "eq", "ne", "select_n",
    "and", "or", "xor", "not",
    "shift_left", "shift_right_logical", "shift_right_arithmetic",
    "convert_element_type", "bitcast_convert_type", "is_finite",
    "stop_gradient", "real", "imag",
})

# Single-PE accumulator / scan ops: one PE with a feedback register; the
# pipeline depth grows with log2 of the reduced extent (a balanced tree
# of the same ALU op), the slot cost stays one PE.
ACCUM_PRIMS = frozenset({
    "reduce_sum", "reduce_max", "reduce_min", "reduce_prod",
    "reduce_and", "reduce_or", "reduce_xor",
    "cumsum", "cumprod", "cummax", "cummin", "cumlogsumexp",
    "argmax", "argmin",
})

# Pure data-steering absorbed by the interconnect / address generators:
# no ALU slot, but each consumes routing budget.
ROUTE_PRIMS = frozenset({
    "reshape", "broadcast_in_dim", "broadcast", "concatenate", "slice",
    "squeeze", "expand_dims", "transpose", "rev", "pad", "iota",
    "dynamic_slice", "dynamic_update_slice", "copy", "split",
    "device_put",
})

# Call-like primitives the mapper recurses through rather than placing.
CALL_PRIMS = frozenset({
    "pjit", "closed_call", "core_call", "xla_call", "custom_jvp_call",
    "custom_vjp_call", "custom_jvp_call_jaxpr", "remat", "checkpoint",
    "custom_vjp_call_jaxpr", "name",
})


@dataclasses.dataclass(frozen=True)
class CGRADevice:
    """One switch's CGRA extension, parameterized like the paper's build.

    The defaults mirror the paper's Table II accelerator: a 250 MHz
    fabric clock moving 64 B per cycle through the processing pipe
    (the old ``NetParams.accel_clock * accel_width`` line rate is
    exactly ``line_rate`` of this device at II = 1).
    """

    name: str = "acis_switch_v1"
    rows: int = 4                 # PE grid: one row per pipeline level
    cols: int = 4
    ops_per_pe: int = 2           # time-multiplexed ALU slots per PE
    lane_bytes: int = 64          # payload bytes entering the array/cycle
    clock_hz: float = 250e6       # fabric clock (Vitis build, 250 MHz)
    max_depth: int = 32           # pipeline registers along one path
    #   (registers are cheap; 32 admits the blockwise-int8 quantize
    #   pipeline — absmax tree over a 256 block is 8 levels by itself —
    #   while PEs/op-slots stay the binding resource)
    route_budget: int = 64        # steering ops the interconnect absorbs
    supported: frozenset = ALU_PRIMS

    @property
    def n_pes(self) -> int:
        return self.rows * self.cols

    @property
    def op_slots(self) -> int:
        return self.n_pes * self.ops_per_pe

    @property
    def line_rate(self) -> float:
        """Bytes/s through the array at II = 1 (a bare Type-1 combine)."""
        return self.clock_hz * self.lane_bytes


PAPER_CGRA = CGRADevice()


@dataclasses.dataclass(frozen=True)
class Placement:
    """A mapped stage: where the op-graph sits and what it sustains.

    ``pes`` holds (row, col) coordinates of occupied PEs (level-major —
    the list-scheduler places level ``l`` ops on row ``l % rows``).
    ``ii`` > 1 means the graph needed more ALU slots than PEs in one
    wave, so PEs are time-multiplexed and throughput drops to
    ``line_rate / ii``.
    """

    device: CGRADevice
    n_ops: int                        # ALU + accumulator ops placed
    n_route: int                      # steering ops absorbed by routing
    depth: int                        # pipeline latency in levels
    ii: int                           # initiation interval (cycles/input)
    pes: tuple = ()                   # occupied (row, col) coordinates
    ops: tuple = ()                   # primitive names, level order
    note: str = ""

    fits: bool = dataclasses.field(default=True, init=False, repr=False)

    @property
    def pes_used(self) -> int:
        return len(self.pes)

    @property
    def bytes_per_s(self) -> float:
        """Sustained throughput of the mapped pipeline."""
        return self.device.line_rate / max(self.ii, 1)

    @property
    def cycles_per_element(self) -> float:
        """Cycles per ``lane_bytes`` input word-group."""
        return float(max(self.ii, 1))

    def describe(self) -> str:
        if self.n_ops == 0:
            return f"route-through ({self.n_route} steer ops, 0 PEs)"
        return (f"{self.pes_used}/{self.device.n_pes} PEs, "
                f"depth {self.depth}, II {self.ii}, "
                f"{self.bytes_per_s / 1e9:.1f} GB/s")


def route_through(device: CGRADevice, n_route: int = 0,
                  note: str = "") -> Placement:
    """A stage with no ALU work: pure forwarding / source-rank reformat.

    Shape bookkeeping (pad/unpad), replication, and plain store-and-
    forward movement occupy zero PEs and stream at the full line rate.
    """
    return Placement(device=device, n_ops=0, n_route=n_route, depth=0,
                     ii=1, pes=(), ops=(), note=note or "pure data movement")


@dataclasses.dataclass(frozen=True)
class HostFallback:
    """The stage's compute body does not fit the switch CGRA.

    Execution is unchanged (the emitted shard_map program still runs the
    op at the endpoint — that is exactly what "fallback" means); the
    *cost model* charges the stage a PCIe + MPI host detour instead of
    the in-switch rate, so schedules and benchmarks stop pretending.
    """

    reason: str

    fits: bool = dataclasses.field(default=False, init=False, repr=False)

    def describe(self) -> str:
        return f"host-fallback: {self.reason}"


PlacementLike = "Placement | HostFallback"


def placement_rate(placement: Optional[object],
                   device: CGRADevice = PAPER_CGRA) -> float:
    """In-switch compute throughput (bytes/s) of a stage.

    ``None`` (no mapper ran — e.g. a hand-built pipeline without
    PlaceCGRA) and route-through placements stream at the device line
    rate; a mapped graph sustains ``line_rate / II``.  Host fallbacks
    have *no* in-switch rate — callers must cost the detour explicitly
    (see :func:`repro_torch.core.netmodel.host_fallback_time`); asking for a
    rate anyway is a modeling bug, so it raises.
    """
    if placement is None:
        return device.line_rate
    if not getattr(placement, "fits", True):
        raise ValueError(
            f"host-fallback stage has no in-switch rate "
            f"({placement.describe()}); cost it as a host detour")
    return placement.bytes_per_s
