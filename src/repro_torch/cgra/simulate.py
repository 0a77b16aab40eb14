"""Cycle-approximate switch dataplane simulator.

The PyTorch counterpart of :mod:`repro.cgra.simulate`.  It executes a
compiled switch program (:class:`repro_torch.core.compiler.
CompiledProgram`) across N *simulated* ranks in a single process: every
collective stage is interpreted hop by hop with exactly the chunk walk and
per-hop combine order of the :mod:`repro_torch.core.ring` schedules, and
a discrete-event clock per rank advances by link latency + serialization
+ in-switch (or host-detour) compute per hop.

Two outputs per run:

  * the program's results for every rank — bitwise equal to executing the
    same ``CompiledProgram`` inside ``with LocalMesh(...)`` wherever the
    arithmetic is the same (identity codecs, the int8 codecs), which is
    how the tests validate the dataplane;
  * a :class:`SimReport` putting the *simulated* per-stage latency next
    to the :func:`repro_torch.core.netmodel.stage_time` analytic
    prediction, stage by stage, with the CGRA placement (or host
    fallback) that produced the compute rate.  Stages execute in
    :class:`~repro_torch.core.executor.ExecutionPlan` wave order: within a
    wave, stages on different mesh axes overlap on disjoint clock
    branches, so ``report.t_end`` (overlapped end-to-end) validates the
    :func:`repro_torch.core.netmodel.program_time` overlap model while the
    per-stage sum ``report.t_sim`` remains the serial cost.  Every time in
    the report is the cost model's, for the paper's switch — not a time on
    the device the data lives on.

**Data on the device, rank-stacked.**  Where the reference keeps one
numpy array per rank and loops over them, the port keeps each value as
one tensor ``[n_ranks, *local]`` on its device and views the ranks of one
axis as ``[R, n, ...]`` — ``R`` independent rings of ``n`` ranks (the
reference's ``_rings``: the axis moved last, the other grid dims
flattened in front).  One ring step is one launch over all rings: the
incoming buffer is the roll of the partial sums along the ring dim (kept
explicit — it models the wire), the local operand a per-rank gather of
chunk ``(i - 2 - s) % n``, and ``combine(incoming, local)`` the
elementwise ``fused_combine`` kernel for ``add``/``max``/``min`` in f32
and bf16 (:mod:`repro_torch.kernels.fused_combine`).  Each element keeps
the reference's fold order, so the result is bitwise its per-rank walk.
The encoded int8 walk combines with ``quant_combine``, the ``topk`` EF
compressor scatter-adds with ``topk_accumulate_``, and the inclusive-add
``scan+allgather`` scans with ``prefix_sum`` — with ``use_kernels`` on
(the engine's default, ``$ACIS_USE_KERNELS``) and CUDA tensors.  CPU
tensors take the kernels' plain versions either way.

**The clock stays host float64** (numpy): the cost model's bookkeeping,
copied operation for operation from the reference, so every timing field
of :class:`SimReport` equals the reference's for the same plan and
placements.

MAP bodies run on the rank-stacked grid ``[*grid, *local]`` inside a
:class:`~repro_torch.mesh.LocalMesh` of the topology's axes — the port's
bodies read axis sizes from the ambient transport, so no ``vmap`` frame is
needed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.cgra.device import PAPER_CGRA
from repro_torch.core import netmodel
from repro_torch.core.program import OpKind
from repro_torch.core.switchops import WIDENED
from repro_torch.core.types import ADD, TensorSpec
from repro_torch.core.wire import IDENTITY, int8_codec
from repro_torch.kernels import chunk_scan as _cs
from repro_torch.kernels import fused_combine as _fc
from repro_torch.kernels import quant_combine as _qc
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import topk_accum as _ta
from repro_torch.kernels.ref import block_scale
from repro_torch.mesh import LocalMesh, default_device
from repro_torch.obs import metrics as _obs

Array = np.ndarray

# dtypes the elementwise combine and scan kernels take
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _codec_block(codec) -> Optional[int]:
    """The block size of a blockwise-int8 codec (``int8_b<block>``)."""
    name = getattr(codec, "name", "")
    if name.startswith("int8_b"):
        return int(name[len("int8_b"):])
    return None


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Injected faults for a :class:`SwitchSim` run.

    ``dead`` ranks are *endpoint-dead*: the switch port still forwards
    (the fabric is alive, so the data path and every buffer shape are
    unchanged — a masked program zeroes their stale contribution via the
    alive input), but the rank is spliced out of ring timing — it never
    injects, never delays a hop, and each ring contracts to its live
    members.  Live ranks pay ``detect_timeout_s`` per dead rank once at
    run start (the deadline the runtime waits before masking), which is
    what makes the sync-time-vs-dead-fraction curve a *line* — detection
    cost in, hop savings out — instead of a cliff.

    ``straggler_s`` maps rank → extra seconds that rank adds to every
    hop it receives (the mean of its delay distribution).
    ``degraded_links`` maps axis → k: links on that axis run at 1/k
    bandwidth with k× link latency.
    """

    dead: frozenset = frozenset()
    straggler_s: tuple = ()            # ((rank, seconds), ...)
    degraded_links: tuple = ()         # ((axis, k), ...)
    detect_timeout_s: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "dead", frozenset(self.dead))
        object.__setattr__(self, "straggler_s",
                           tuple(sorted(dict(self.straggler_s).items())))
        object.__setattr__(self, "degraded_links",
                           tuple(sorted(dict(self.degraded_links).items())))
        for ax, k in self.degraded_links:
            if k < 1:
                raise ValueError(
                    f"degraded link on {ax!r}: k must be ≥1, got {k}")

    def __bool__(self) -> bool:
        return bool(self.dead or self.straggler_s or self.degraded_links)


@dataclasses.dataclass(frozen=True)
class SimStage:
    kind: str
    axis: str
    schedule: str
    t_sim: float                  # simulated wall time of the stage (s)
    t_model: Optional[float]      # netmodel.stage_time prediction (s)
    placement: Any = None
    wave: int = 0                 # ExecutionPlan wave the stage ran in
    # global start timestamp of the stage on its wave branch (s) and the
    # stage's injection-serialization share (the part of t_sim the shared
    # port stays busy — what the wave merge re-exposes for non-critical
    # branches).  Together with t_sim these are exactly the fields
    # repro_torch.tune.trace.StageTrace records, so simulated traces drive
    # the record → fit → replay → search loop without hardware.
    t_start: float = 0.0
    t_ser: float = 0.0

    @property
    def deviation(self) -> Optional[float]:
        if not self.t_model:
            return None
        return self.t_sim / self.t_model


@dataclasses.dataclass
class SimReport:
    stages: list[SimStage]
    axes: dict                    # axis name -> size
    # end-to-end simulated latency with wave overlap (stages of one wave
    # on different axes run concurrently); ≤ t_sim, the serial stage sum
    t_end: float = 0.0
    # netmodel.program_time of the same plan — the analytic overlap
    # model's prediction for t_end (None without a compile topology)
    t_program_model: Optional[float] = None
    # per-rank completion timestamps (s) — what deadline verdicts and the
    # drift watchdog's per-rank span pools read; dead ranks report their
    # frozen clock
    rank_t_end: tuple = ()

    @property
    def t_sim(self) -> float:
        return sum(s.t_sim for s in self.stages)

    @property
    def t_model(self) -> float:
        return sum(s.t_model or 0.0 for s in self.stages)

    def table(self) -> str:
        rows = [("wv", "kind", "axis", "sched", "sim_us", "model_us",
                 "placement")]
        for s in self.stages:
            pl = s.placement.describe() if s.placement is not None else "-"
            rows.append((str(s.wave), s.kind, s.axis or "-",
                         s.schedule or "-",
                         f"{s.t_sim * 1e6:9.2f}",
                         f"{(s.t_model or 0.0) * 1e6:9.2f}", pl))
        rows.append(("", "TOTAL", "", "", f"{self.t_sim * 1e6:9.2f}",
                     f"{self.t_model * 1e6:9.2f}", ""))
        rows.append(("", "END-TO-END", "", "", f"{self.t_end * 1e6:9.2f}",
                     f"{(self.t_program_model or 0.0) * 1e6:9.2f}",
                     "(waves overlapped)"))
        w = [max(len(r[c]) for r in rows) for c in range(6)]
        return "\n".join(
            "  ".join(r[c].ljust(w[c]) for c in range(6)) + "  " + r[6]
            for r in rows)


# ---------------------------------------------------------------------------
# the stacked ring walks (every ring of an axis at once)
# ---------------------------------------------------------------------------

def ring_reduce_scatter(x: torch.Tensor, combine: Callable) -> torch.Tensor:
    """Ring reduce-scatter over ``R`` independent rings at once, in the
    exact hop and fold order of :func:`repro_torch.core.ring.
    ring_reduce_scatter`.

    ``x`` is ``[R, n, n*c, *rest]``: ring ``g``'s rank ``i`` holds
    ``x[g, i]``, split along its first local dim into ``n`` chunks.  Rank
    ``i`` starts from its chunk ``(i - 1) % n``; at step ``s`` it receives
    its upstream neighbour's partial sum (the roll along the ring dim)
    and folds ``combine(incoming, chunk (i - 2 - s) % n)`` — incoming
    first.  One ``combine`` call per step covers every rank of every
    ring.  Returns ``[R, n, c, *rest]``: rank ``i``'s reduced chunk."""
    n = x.shape[1]
    if x.shape[2] % n:
        raise ValueError(f"ring payload dim {x.shape[2]} does not split "
                         f"into {n} chunks")
    chunks = x.reshape(tuple(x.shape[:2]) + (n, x.shape[2] // n)
                       + tuple(x.shape[3:]))
    r = torch.arange(n, device=x.device)
    buf = chunks[:, r, (r - 1) % n]
    for s in range(n - 1):
        incoming = torch.roll(buf, 1, dims=1)
        buf = combine(incoming, chunks[:, r, (r - 2 - s) % n])
    return buf


def ring_all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank of each ring gets the rank-major concatenation of the
    ring's blocks: ``[R, n, b, *rest]`` → ``[R, n, n*b, *rest]``."""
    rings, n = x.shape[:2]
    full = x.reshape((rings, n * x.shape[2]) + tuple(x.shape[3:]))
    return full[:, None].expand((rings, n) + tuple(full.shape[1:])) \
        .contiguous()


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

class SwitchSim:
    """A multi-port switch fabric simulated at rank granularity.

    ``topology`` is either a :class:`repro_torch.core.compiler.Topology`
    (axis order = leading-dim order of the inputs; per-axis link tiers are
    honored) or a ``{axis: size}`` mapping (all axes on the fast tier).
    ``device`` is the CGRA device (the reference's meaning).
    ``use_kernels`` selects the hand-written CUDA kernels for the per-step
    combines on CUDA tensors; None means the engine's default
    (``$ACIS_USE_KERNELS``).  CPU tensors take the plain versions either
    way.
    """

    def __init__(self, topology, *, device=PAPER_CGRA,
                 faults: Optional[FaultPlan] = None,
                 use_kernels: Optional[bool] = None):
        if hasattr(topology, "axes"):          # compiler.Topology
            self.axis_names = [a.name for a in topology.axes]
            self.sizes = {a.name: int(a.size) for a in topology.axes}
            self.nets = {a.name: topology.net(a.name)
                         for a in topology.axes}
        else:
            self.axis_names = list(topology)
            self.sizes = {a: int(n) for a, n in dict(topology).items()}
            self.nets = {a: netmodel.PAPER for a in self.axis_names}
        if any(n <= 0 for n in self.sizes.values()):
            raise ValueError(f"axis sizes must be concrete: {self.sizes}")
        self.grid = tuple(self.sizes[a] for a in self.axis_names)
        self.n_ranks = int(np.prod(self.grid))
        self.device = device
        if use_kernels is None:
            from repro_torch.core.api import _use_kernels_default
            use_kernels = _use_kernels_default()
        self.use_kernels = bool(use_kernels)
        # healthy-fabric params, frozen before fault injection: t_model
        # predictions price against these, so a degraded link shows up as
        # sim/model drift the watchdog can attribute to the axis instead
        # of silently re-baselining the prediction onto the fault
        self.model_nets = dict(self.nets)
        self.faults = faults if faults else None
        self._alive = np.ones((self.n_ranks,), bool)
        self._straggler = np.zeros((self.n_ranks,), np.float64)
        if self.faults is not None:
            bad = [r for r in self.faults.dead
                   if not 0 <= r < self.n_ranks]
            bad += [r for r, _ in self.faults.straggler_s
                    if not 0 <= r < self.n_ranks]
            if bad:
                raise ValueError(
                    f"fault ranks {sorted(set(bad))} out of range "
                    f"0..{self.n_ranks - 1}")
            for r in self.faults.dead:
                self._alive[r] = False
            for r, s in self.faults.straggler_s:
                self._straggler[r] = float(s)
            for ax, k in self.faults.degraded_links:
                if ax not in self.nets:
                    raise ValueError(f"degraded link on unknown axis {ax!r}")
                p = self.nets[ax]
                self.nets[ax] = dataclasses.replace(
                    p, bw=p.bw / k, fpga_link=p.fpga_link * k)
        # per-rank injection-serialization account of the wave branch
        # currently executing (set by run() around each stage)
        self._cur_ser: Optional[Array] = None

    # -- rank bookkeeping ---------------------------------------------------

    def _rings(self, axis: str) -> list[np.ndarray]:
        """Flat rank index groups forming independent rings along ``axis``."""
        ids = np.arange(self.n_ranks).reshape(self.grid)
        k = self.axis_names.index(axis)
        moved = np.moveaxis(ids, k, -1)
        return [g for g in moved.reshape(-1, self.grid[k])]

    def _ring_view(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``[n_ranks, *local]`` → ``[R, n, *local]``: the rings of
        ``axis`` in :meth:`_rings` order (the axis moved last, the other
        grid dims flattened in front)."""
        g = len(self.grid)
        k = self.axis_names.index(axis)
        y = x.reshape(self.grid + tuple(x.shape[1:])).movedim(k, g - 1)
        return y.reshape((-1, self.grid[k]) + tuple(x.shape[1:]))

    def _unring(self, y: torch.Tensor, axis: str) -> torch.Tensor:
        """The inverse of :meth:`_ring_view`, for ``[R, n, *out]``."""
        g = len(self.grid)
        k = self.axis_names.index(axis)
        moved = tuple(s for j, s in enumerate(self.grid) if j != k) \
            + (self.grid[k],)
        out = y.reshape(moved + tuple(y.shape[2:])).movedim(g - 1, k)
        return out.reshape((self.n_ranks,) + tuple(y.shape[2:])) \
            .contiguous()

    @staticmethod
    def _ring_mesh(rings: int, axis: str, n: int,
                   device) -> LocalMesh:
        """The transport a rank-local codec runs under on a ring view:
        rank dims ``(R, n)``."""
        return LocalMesh({"rings": rings, axis: n}, device=device)

    # -- the per-step combines ----------------------------------------------

    def _combine_fn(self, monoid, dtype) -> Callable:
        """``monoid.combine``, as the elementwise ``fused_combine`` kernel
        for add/max/min in f32 and bf16 under ``use_kernels`` (a CPU
        operand takes its plain version inside the wrapper); an fp8 wire
        combines through the f32 kernel, rounded once to its dtype, as the
        monoid's own combine does."""
        op = getattr(monoid, "name", "")
        if not (self.use_kernels and op in _fc.HOP_OPS):
            return monoid.combine
        if dtype in _KERNEL_DTYPES:
            return lambda a, b: _fc.fused_combine(
                a.contiguous(), b.contiguous(), op=op)
        if dtype in WIDENED:
            return lambda a, b: _fc.fused_combine(
                a.float(), b.float(), op=op).to(dtype)
        return monoid.combine

    def _encoded_combine(self, codec) -> Callable:
        """``(qa, sa, qb, sb) -> (q, s)``: the int8 codec's encoded
        combine, the ``quant_combine`` kernel under ``use_kernels``."""
        if self.use_kernels and _codec_block(codec) == _qc.QBLOCK:
            return lambda qa, sa, qb, sb: _qc.quant_combine(
                qa.contiguous(), sa.contiguous(), qb.contiguous(),
                sb.contiguous())
        return lambda qa, sa, qb, sb: codec.combine_encoded((qa, sa),
                                                            (qb, sb))

    # -- timing -------------------------------------------------------------

    @staticmethod
    def _hop_time(p, chunk_bytes: float, compute_bytes: float,
                  placement) -> float:
        """One ring hop: link + serialization + per-hop compute.

        A fitting placement streams the compute at its sustained rate; a
        host fallback detours the chunk over PCIe and computes at the
        endpoint (the per-stage MPI injection is charged separately).
        """
        t = p.fpga_link + p.port + chunk_bytes / p.bw
        if compute_bytes:
            if placement is not None and not placement.fits:
                t += 2 * p.pcie + compute_bytes / p.host_bw
            else:
                t += compute_bytes / netmodel.accel_rate(p, placement)
        return t

    def _advance_ring(self, clock: Array, axis: str, steps: int,
                      t_hop: float, ser_hop: float = 0.0) -> None:
        """Discrete-event update: each step, every rank's clock becomes
        max(own, upstream neighbour) + hop time, per ring of the axis.

        ``ser_hop`` is the *injection-serialization* share of the hop
        (chunk bytes / link bw): the time the rank's shared port is
        busy pushing this branch's bytes.  It accrues into the current
        wave branch's serialization account — concurrent branches of one
        wave overlap their propagation and compute, but their injection
        contends at the port, so the wave merge re-exposes the
        non-critical branches' serialization (see :meth:`run`).

        Under a :class:`FaultPlan`, each ring contracts to its live
        members (dead ports are cut through, so a lap needs fewer hops:
        the step count caps at live−1), stragglers add their per-hop
        delay to every hop they receive, and dead ranks neither inject
        nor advance.
        """
        faulty = self.faults is not None
        for g in self._rings(axis):
            gl = g[self._alive[g]] if faulty else g
            n_live = len(gl)
            if n_live < 2:
                continue
            eff = min(max(steps, 0), n_live - 1) if faulty else max(steps, 0)
            extra = self._straggler[gl] if faulty else 0.0
            for _ in range(eff):
                vals = clock[gl]
                clock[gl] = np.maximum(vals, np.roll(vals, 1)) \
                    + t_hop + extra
            if ser_hop and eff > 0 and self._cur_ser is not None:
                self._cur_ser[gl] += eff * ser_hop

    def _advance_local(self, clock: Array, t: float) -> None:
        clock += t

    # -- public entry -------------------------------------------------------

    def run(self, compiled, *inputs) -> tuple[Any, SimReport]:
        """Execute ``compiled`` over per-rank inputs, wave by wave.

        Every input is shaped ``grid + local_shape`` (leading dims in
        topology-axis order).  A tensor stays on its device; a numpy array
        goes to :func:`repro_torch.mesh.default_device` (the card, which
        raises without one).  Returns ``(outputs, report)`` with outputs
        in the same convention, on the inputs' device.

        Stages are walked in :class:`~repro_torch.core.executor.
        ExecutionPlan` wave order.  Within one wave, stages traversing
        *different* mesh axes occupy disjoint links and advance
        independent clock branches from the wave-start snapshot (true
        overlap); stages sharing an axis serialize on that axis's rings.
        The wave ends at the element-wise max of its branches — so
        ``report.t_end`` measures the overlapped end-to-end latency the
        analytic :func:`repro_torch.core.netmodel.program_time` predicts,
        while the per-stage ``t_sim`` entries still sum to the serial
        cost.
        """
        src = compiled.source
        if len(inputs) != src.num_inputs:
            raise TypeError(f"program takes {src.num_inputs} inputs, "
                            f"got {len(inputs)}")
        env: dict[int, torch.Tensor] = {}
        for i, x in enumerate(inputs):
            if not isinstance(x, torch.Tensor):
                x = torch.as_tensor(np.asarray(x), device=default_device())
            if tuple(x.shape[:len(self.grid)]) != self.grid:
                raise ValueError(
                    f"input {i} must lead with the rank grid {self.grid}, "
                    f"got shape {tuple(x.shape)}")
            env[i] = x.reshape((self.n_ranks,)
                               + tuple(x.shape[len(self.grid):]))

        plan = getattr(compiled, "plan", None)
        waves = plan.waves if plan is not None \
            else tuple((i,) for i in range(len(compiled.stages)))
        clock = np.zeros((self.n_ranks,), np.float64)
        if self.faults is not None and self.faults.dead:
            # every live rank waits out the detection deadline once per
            # dead peer before masking it — the linear term of the
            # degradation curve
            n_dead = len(self.faults.dead)
            clock[self._alive] += n_dead * self.faults.detect_timeout_s
            _obs.RECORDER.count("sim.dead_ranks", n_dead)
        rows: dict[int, SimStage] = {}
        for wi, wave in enumerate(waves):
            branch: dict[str, Array] = {}
            branch_ser: dict[str, Array] = {}
            for si in wave:
                st = compiled.stages[si]
                if st.ir is None:
                    raise ValueError(
                        f"stage {st.kind!r} carries no StageIR — the "
                        "program was compiled by a pipeline the simulator "
                        "cannot interpret (use the default pipeline)")
                c = branch.get(st.axis)
                if c is None:
                    c = branch[st.axis] = clock.copy()
                    branch_ser[st.axis] = np.zeros_like(clock)
                self._cur_ser = branch_ser[st.axis]
                t0 = float(c.max())
                s0 = float(branch_ser[st.axis].max())
                args = [env[v] for v in st.in_vids]
                try:
                    outs = self._exec(st, args, c)
                finally:
                    self._cur_ser = None
                for vid, o in zip(st.out_vids, outs):
                    env[vid] = o
                t_sim = float(c.max()) - t0
                rows[si] = SimStage(
                    st.kind, st.axis, st.schedule, t_sim,
                    self._model_time(st, args), st.placement, wi,
                    t_start=t0,
                    t_ser=float(branch_ser[st.axis].max()) - s0)
            if branch:
                # concurrent branches overlap propagation and compute,
                # but every rank injects into all of its rings through
                # one shared port: the wave ends at the per-rank max
                # branch plus the *other* branches' injection-
                # serialization time (the contention the calibrated
                # netmodel.TIER_OVERLAP fractions price)
                clocks = np.stack(list(branch.values()))
                sers = np.stack([branch_ser[a] for a in branch])
                arg = np.argmax(clocks, axis=0)
                exposed = sers.sum(axis=0) \
                    - np.take_along_axis(sers, arg[None], axis=0)[0]
                clock = clocks.max(axis=0) + exposed

        outs = tuple(env[v].reshape(self.grid + tuple(env[v].shape[1:]))
                     for v in src.outputs)
        t_prog = None
        topo = getattr(compiled, "topology", None)
        if plan is not None and topo is not None:
            t_prog = netmodel.program_time(plan, topo)
        t_end = float(clock[self._alive].max()) \
            if self._alive.any() else float(clock.max())
        report = SimReport([rows[i] for i in sorted(rows)],
                           dict(self.sizes), t_end, t_prog,
                           rank_t_end=tuple(float(t) for t in clock))
        rec = _obs.RECORDER
        if rec.enabled:
            rec.count("sim.runs")
            rec.count("sim.stages", len(report.stages))
        return (outs[0] if len(outs) == 1 else outs), report

    # -- per-stage analytic prediction --------------------------------------

    def _model_time(self, st, args: list) -> Optional[float]:
        m = int(_nbytes(args[0]) // self.n_ranks) if args else 0
        m_parts = None
        if st.kind == "allreduce+alltoall" and len(args) == 2:
            m_parts = (int(_nbytes(args[0]) // self.n_ranks),
                       int(_nbytes(args[1]) // self.n_ranks))
            m = sum(m_parts)
        elif st.kind == "map" and st.ir.bytes_in is not None:
            # the plan-consistent map payload: what the stage produces
            # (pack = sum of operands, split = one slice of the bucket)
            m = int(st.ir.bytes_in)
        axis = st.axis
        n = self.sizes.get(axis, 1)
        p = self.model_nets.get(axis, netmodel.PAPER)
        ratio = 1.0
        for nd in st.ir.nodes:
            if nd.op.codec is not IDENTITY:
                ratio = float(nd.op.codec.wire_ratio)
        try:
            return netmodel.stage_time(st.kind, n, m, p,
                                       placement=st.placement,
                                       schedule=st.schedule,
                                       codec_ratio=ratio,
                                       m_parts=m_parts)
        except ValueError:
            return None

    # -- stage interpreters --------------------------------------------------

    def _exec(self, st, args: list, clock: Array) -> tuple:
        kind = st.kind.replace("+", "_")
        return getattr(self, "_run_" + kind)(st, args, clock)

    # .. local map ..........................................................

    def _apply_map(self, fn: Callable, args: list) -> torch.Tensor:
        grid_args = [a.reshape(self.grid + tuple(a.shape[1:]))
                     for a in args]
        with LocalMesh(self.sizes, device=args[0].device):
            out = fn(*grid_args)
        return out.reshape((self.n_ranks,)
                           + tuple(out.shape[len(self.grid):]))

    def _run_map(self, st, args, clock):
        fn = st.ir.nodes[0].op.fn
        out = self._apply_map(fn, args)
        p = netmodel.PAPER
        pl = st.placement
        # a map streams what it produces: a Coalesce bucket pack emits the
        # sum of its operands, a bucket split only its own slice
        m = int(_nbytes(out) // self.n_ranks)
        if pl is not None and not pl.fits:
            self._advance_local(clock, netmodel.host_fallback_time(m, p))
        else:
            self._advance_local(clock, m / netmodel.accel_rate(p, pl))
        return (out,)

    # .. ring all-reduce family .............................................

    def _ring_ag(self, blocks: torch.Tensor, axis: str,
                 hop_map: Optional[Callable] = None) -> torch.Tensor:
        """The ring all-gather of ``[R, n, *blk]``; ``hop_map`` (a
        rank-local map body) is applied to every block in flight."""
        if hop_map is not None:
            with self._ring_mesh(blocks.shape[0], axis, blocks.shape[1],
                                 blocks.device):
                blocks = hop_map(blocks)
        return ring_all_gather(blocks)

    def _allreduce_ring(self, blocks: torch.Tensor, axis: str, monoid,
                        codec, latency: bool) -> torch.Tensor:
        """All-reduce of ``[R, n, *local]`` over every ring at once."""
        rings, n = blocks.shape[:2]
        if n == 1:
            return blocks
        if codec is not IDENTITY and codec.combine_encoded is not None:
            return self._allreduce_encoded(blocks, axis, codec)
        if codec is not IDENTITY:            # cast-style codec
            enc = codec.encode(blocks)
            red = self._allreduce_ring(enc, axis, monoid, IDENTITY, latency)
            return codec.decode(red).to(blocks.dtype)
        combine = self._combine_fn(monoid, blocks.dtype)
        if latency:
            acc = blocks
            for s in range(1, n):
                acc = combine(acc, torch.roll(blocks, s, dims=1))
            return acc
        shape = tuple(blocks.shape[2:])
        flat = blocks.reshape(rings, n, -1)
        size = flat.shape[-1]
        pad = (-size) % n
        if pad:
            # mirror ring.pad_to_multiple(..., monoid=): pad lanes carry
            # the monoid identity, not literal zeros
            fill = monoid.identity(TensorSpec((rings, n, pad), flat.dtype,
                                              flat.device))
            flat = torch.cat([flat, fill], dim=-1)
        red = ring_reduce_scatter(flat, combine)
        full = ring_all_gather(red)
        return full[..., :size].reshape((rings, n) + shape)

    def _allreduce_encoded(self, blocks: torch.Tensor, axis: str,
                           codec) -> torch.Tensor:
        """Mirror of ``collectives._tree_all_reduce_encoded`` on the int8
        codec's payload: encode once, chunked reduce-scatter walk with the
        encoded-domain combine (one ``quant_combine`` launch a step over
        every rank of every ring, payload ``[R, n, rows, 256]`` and scales
        ``[R, n, rows]``), gather, decode."""
        rings, n = blocks.shape[:2]
        dev = blocks.device
        with self._ring_mesh(rings, axis, n, dev):
            q, s = codec.encode(blocks)
        nblocks = q.shape[2]
        pad = (-nblocks) % n
        if pad:
            q = torch.cat([q, q.new_zeros((rings, n, pad)
                                          + tuple(q.shape[3:]))], dim=2)
            s = torch.cat([s, s.new_zeros((rings, n, pad)
                                          + tuple(s.shape[3:]))], dim=2)
        qc = q.reshape((rings, n, n, q.shape[2] // n) + tuple(q.shape[3:]))
        sc = s.reshape((rings, n, n, s.shape[2] // n) + tuple(s.shape[3:]))
        combine = self._encoded_combine(codec)
        r = torch.arange(n, device=dev)
        qb, sb = qc[:, r, (r - 1) % n], sc[:, r, (r - 1) % n]
        for step in range(n - 1):
            c = (r - 2 - step) % n
            qb, sb = combine(torch.roll(qb, 1, dims=1),
                             torch.roll(sb, 1, dims=1),
                             qc[:, r, c], sc[:, r, c])
        # all-gather: contributor rank j supplies chunk j
        gq = qb.reshape((rings, -1) + tuple(qb.shape[3:]))[:, :nblocks]
        gs = sb.reshape((rings, -1) + tuple(sb.shape[3:]))[:, :nblocks]
        with LocalMesh({"rings": rings}, device=dev):
            out = codec.decode((gq, gs))
        return out[:, None].expand((rings, n) + tuple(out.shape[1:])) \
            .contiguous()

    def _per_ring(self, axis: str, arg: torch.Tensor,
                  fn: Callable[[torch.Tensor], torch.Tensor]
                  ) -> torch.Tensor:
        """Apply a ring interpreter along ``axis`` to ``[R, n, ...]``;
        other grid coords are independent switch ports."""
        return self._unring(fn(self._ring_view(arg, axis)), axis)

    def _stage_net(self, st):
        return self.nets.get(st.axis, netmodel.PAPER), \
            self.sizes.get(st.axis, 1)

    def _charge_ring(self, st, clock, per_rank_bytes: float, *,
                     steps: Optional[int] = None, chunked: bool = True,
                     compute: bool = True) -> None:
        p, n = self._stage_net(st)
        if n <= 1:
            return
        steps = steps if steps is not None else n - 1
        chunk = per_rank_bytes / n if chunked else per_rank_bytes
        pl = st.placement
        if pl is not None and not pl.fits and compute:
            # one software injection for the stage's host detour — only
            # on the half that actually computes (an RS∘AG walk must not
            # charge it twice)
            self._advance_local(clock, p.mpi_overhead)
        t_hop = self._hop_time(p, chunk, chunk if compute else 0.0, pl)
        self._advance_ring(clock, st.axis, steps, t_hop,
                           ser_hop=chunk / p.bw)

    # .. stage handlers ......................................................

    def _wire_ratio(self, st) -> float:
        for nd in st.ir.nodes:
            if nd.op.codec is not IDENTITY:
                return float(nd.op.codec.wire_ratio)
        return 1.0

    def _run_allreduce(self, st, args, clock):
        op = next(nd.op for nd in st.ir.nodes
                  if nd.op.kind in (OpKind.REDUCE, OpKind.REDUCE_SCATTER))
        latency = st.schedule == "latency"
        out = self._per_ring(
            st.axis, args[0],
            lambda blocks: self._allreduce_ring(blocks, st.axis, op.monoid,
                                                op.codec, latency))
        m = _nbytes(args[0]) / self.n_ranks * self._wire_ratio(st)
        if latency:
            self._charge_ring(st, clock, m, chunked=False)
        else:
            self._charge_ring(st, clock, m)                  # RS half
            self._charge_ring(st, clock, m, compute=False)   # AG half
        return (out,)

    # a batched ring (Coalesce batch_rings) is one ring over the stacked
    # payload — identical dataplane walk, so the analytic/simulated
    # agreement for "allreduce" carries over unchanged
    _run_batched_allreduce = _run_allreduce

    def _run_map_allreduce(self, st, args, clock):
        mp = st.ir.nodes[0].op
        mapped = self._apply_map(mp.fn, args)
        return self._run_allreduce(st, [mapped], clock)

    def _run_reduce_scatter(self, st, args, clock):
        op = next(nd.op for nd in st.ir.nodes
                  if nd.op.kind == OpKind.REDUCE_SCATTER)

        def rs(blocks):
            if blocks.shape[1] == 1:
                return blocks
            if op.codec is not IDENTITY:
                enc = op.codec.encode(blocks)
                red = ring_reduce_scatter(
                    enc, self._combine_fn(op.monoid, enc.dtype))
                return op.codec.decode(red).to(blocks.dtype)
            return ring_reduce_scatter(
                blocks, self._combine_fn(op.monoid, blocks.dtype))

        out = self._per_ring(st.axis, args[0], rs)
        self._charge_ring(st, clock,
                          _nbytes(args[0]) / self.n_ranks
                          * self._wire_ratio(st))
        return (out,)

    def _run_map_reduce_scatter(self, st, args, clock):
        mp = st.ir.nodes[0].op
        mapped = self._apply_map(mp.fn, args)
        return self._run_reduce_scatter(st, [mapped], clock)

    def _run_allgather(self, st, args, clock):
        out = self._per_ring(st.axis, args[0],
                             lambda b: self._ring_ag(b, st.axis))
        self._charge_ring(st, clock, _nbytes(args[0]) / self.n_ranks
                          * (self.sizes.get(st.axis, 1)),
                          compute=False)
        return (out,)

    def _run_allgather_map(self, st, args, clock):
        mp = st.ir.nodes[1].op
        out = self._per_ring(
            st.axis, args[0], lambda b: self._ring_ag(b, st.axis, mp.fn))
        self._charge_ring(st, clock, _nbytes(args[0]) / self.n_ranks
                          * (self.sizes.get(st.axis, 1)))
        return (out,)

    @staticmethod
    def _a2a(blocks: torch.Tensor) -> torch.Tensor:
        """Rank ``r`` receives chunk ``r`` of every rank, rank-major."""
        rings, n = blocks.shape[:2]
        chunks = blocks.reshape((rings, n, n, blocks.shape[2] // n)
                                + tuple(blocks.shape[3:]))
        return chunks.transpose(1, 2).reshape(blocks.shape).contiguous()

    def _run_alltoall(self, st, args, clock):
        out = self._per_ring(st.axis, args[0], self._a2a)
        self._charge_ring(st, clock, _nbytes(args[0]) / self.n_ranks,
                          compute=False)
        return (out,)

    def _scan_blocks(self, blocks: torch.Tensor, monoid,
                     exclusive: bool) -> torch.Tensor:
        """Blockwise rank-prefix scan of ``[R, n, *blk]`` (exclusive
        shifts in the monoid identity at rank 0)."""
        combine = self._combine_fn(monoid, blocks.dtype)
        acc = blocks[:, 0]
        incl = [acc]
        for j in range(1, blocks.shape[1]):
            acc = combine(acc, blocks[:, j])
            incl.append(acc)
        if exclusive:
            ident = monoid.identity(TensorSpec(tuple(acc.shape),
                                               blocks.dtype, blocks.device))
            incl = [ident] + incl[:-1]
        return torch.stack(incl, dim=1)

    def _run_scan(self, st, args, clock):
        op = next(nd.op for nd in st.ir.nodes if nd.op.kind == OpKind.SCAN)
        out = self._per_ring(
            st.axis, args[0],
            lambda b: self._scan_blocks(b, op.monoid, op.exclusive))
        p, n = self._stage_net(st)
        rounds = int(math.ceil(math.log2(max(n, 2)))) if n > 1 else 0
        m = _nbytes(args[0]) / self.n_ranks
        self._advance_ring(clock, st.axis, rounds,
                           self._hop_time(p, m, m, st.placement),
                           ser_hop=m / p.bw)
        return (out,)

    def _run_scan_allgather(self, st, args, clock):
        scan_op = st.ir.nodes[1].op

        def fused(blocks):
            if scan_op.monoid.name == "add" and not scan_op.exclusive:
                # allgather_op_allgather: the inclusive sum of the
                # rank-major concatenation, one prefix_sum over every ring
                rings, n = blocks.shape[:2]
                full = blocks.reshape((rings, n * blocks.shape[2])
                                      + tuple(blocks.shape[3:]))
                if self.use_kernels and full.dtype in _KERNEL_DTYPES:
                    out = _cs.prefix_sum(full.contiguous(), 1)
                else:
                    out = _ref.prefix_sum(full, 1)
                return out[:, None].expand((rings, n)
                                           + tuple(out.shape[1:]))
            # scan_then_allgather: blockwise rank-prefix scan, then gather
            return ring_all_gather(self._scan_blocks(
                blocks, scan_op.monoid, scan_op.exclusive))

        out = self._per_ring(st.axis, args[0], fused)
        p, n = self._stage_net(st)
        m = _nbytes(args[0]) / self.n_ranks
        rounds = int(math.ceil(math.log2(max(n, 2)))) if n > 1 else 0
        self._advance_ring(clock, st.axis, rounds,
                           self._hop_time(p, m, m, st.placement),
                           ser_hop=m / p.bw)
        self._charge_ring(st, clock, m * n, compute=False)   # gather round
        return (out,)

    def _run_bcast(self, st, args, clock):
        op = next(nd.op for nd in st.ir.nodes if nd.op.kind == OpKind.BCAST)
        out = self._per_ring(
            st.axis, args[0],
            lambda b: b[:, op.root:op.root + 1].expand(b.shape))
        p, n = self._stage_net(st)
        rounds = int(math.ceil(math.log2(max(n, 2)))) if n > 1 else 0
        m = _nbytes(args[0]) / self.n_ranks
        self._advance_ring(clock, st.axis, rounds,
                           self._hop_time(p, m, 0.0, st.placement),
                           ser_hop=m / p.bw)
        return (out,)

    def _run_allreduce_alltoall(self, st, args, clock):
        hist_arg, keys_arg = args

        def hist_ring(blocks):
            combine = self._combine_fn(ADD, blocks.dtype)
            acc = blocks
            for s in range(1, blocks.shape[1]):
                acc = combine(acc, torch.roll(blocks, s, dims=1))
            return acc

        hist = self._per_ring(st.axis, hist_arg, hist_ring)
        keys = self._per_ring(st.axis, keys_arg, self._a2a)
        p, n = self._stage_net(st)
        m_keys = _nbytes(keys_arg) / self.n_ranks
        m_hist = _nbytes(hist_arg) / self.n_ranks
        # one shared traversal: key chunk + full histogram per hop
        chunk = m_keys / max(n, 1) + m_hist
        self._advance_ring(
            clock, st.axis, max(n - 1, 0),
            self._hop_time(p, chunk, m_hist, st.placement),
            ser_hop=chunk / p.bw)
        return hist, keys

    # .. look-aside (error feedback) ........................................

    def _run_ef_allreduce(self, st, args, clock):
        ef = st.ir.nodes[0].op.ef
        both = len(st.out_vids) == 2
        total, delivered = self._ef(st, args[0], ef)
        m = _nbytes(args[0]) / self.n_ranks
        p, n = self._stage_net(st)
        pl = st.placement
        if pl is not None and not pl.fits:
            self._advance_local(clock, netmodel.host_fallback_time(m, p))
            self._charge_ring(st, clock, m)
        else:
            # compress locally, tiny scale exchange, half-width RS∘AG walk
            self._advance_local(clock, m / netmodel.accel_rate(p, pl))
            self._advance_ring(clock, st.axis, max(n - 1, 0),
                               self._hop_time(p, max(m / 256, 4), 0.0, pl),
                               ser_hop=max(m / 256, 4) / p.bw)
            self._charge_ring(st, clock, m * 0.5)
            self._charge_ring(st, clock, m * 0.5, compute=False)
        return (total, delivered) if both else (total,)

    def _run_delivered(self, st, args, clock):
        ef = st.ir.nodes[0].op.ef
        _, delivered = self._ef(st, args[0], ef)
        p, _ = self._stage_net(st)
        m = _nbytes(args[0]) / self.n_ranks
        if st.placement is not None and not st.placement.fits:
            self._advance_local(clock, netmodel.host_fallback_time(m, p))
        else:
            self._advance_local(clock,
                                m / netmodel.accel_rate(p, st.placement))
        return (delivered,)

    def _ef(self, st, arg: torch.Tensor, ef
            ) -> tuple[torch.Tensor, torch.Tensor]:
        """Mirror of :func:`repro_torch.core.lookaside.
        compressed_all_reduce`, every ring of the axis at once."""
        dtype = arg.dtype
        tf = self._ring_view(arg, st.axis).to(torch.float32)
        if ef.compressor == "int8":
            tot, dlv = self._ef_int8(tf)
        elif ef.compressor == "int8_hopquant":
            codec = int8_codec()
            tot = self._allreduce_encoded(tf, st.axis, codec)
            with self._ring_mesh(tf.shape[0], st.axis, tf.shape[1],
                                 tf.device):
                dlv = codec.decode(codec.encode(tf))
        elif ef.compressor == "topk":
            tot, dlv = self._ef_topk(tf, ef.topk_ratio)
        else:
            raise ValueError(f"unknown compressor {ef.compressor!r}")
        return (self._unring(tot.to(dtype), st.axis),
                self._unring(dlv, st.axis))

    @staticmethod
    def _ef_int8(tf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Shared-scale exact-integer accumulation (lookaside.QBLOCK) of
        ``[R, n, *local]`` f32."""
        block = 256
        rings, n = tf.shape[:2]
        shape = tuple(tf.shape[2:])
        size = math.prod(shape)
        pad = (-size) % block
        flat = tf.reshape(rings, n, size)
        if pad:
            flat = torch.cat([flat, flat.new_zeros((rings, n, pad))], dim=-1)
        bl = flat.reshape(rings, n, -1, block)
        absmax = bl.abs().amax(dim=-1).amax(dim=1)         # [R, blocks]
        scale = block_scale(absmax)
        qs = torch.clamp(torch.round(bl / scale[:, None, :, None]),
                         -127, 127).to(torch.int16)
        qsum = qs.to(torch.int32).sum(dim=1).to(torch.int16)
        total = (qsum.to(torch.float32) * scale[..., None]) \
            .reshape(rings, -1)[:, :size].reshape((rings, 1) + shape)
        delivered = (qs.to(torch.float32) * scale[:, None, :, None]) \
            .reshape(rings, n, -1)[..., :size].reshape((rings, n) + shape)
        return total.expand((rings, n) + shape), delivered

    def _ef_topk(self, tf: torch.Tensor, ratio: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-k sparse accumulation of ``[R, n, *local]`` f32: each
        rank's ``k`` largest magnitudes (a stable descending sort, the
        executed ``TopK.compress``; the reference's ``argsort`` picks the
        same set wherever the k-th magnitude has no tie), then two
        ``topk_accumulate_`` launches — every rank's own delivered vector
        (ranks write disjoint rows) and every rank's ``(idx, vals)``, rank
        order, into its ring's shared dense sum."""
        rings, n = tf.shape[:2]
        shape = tuple(tf.shape[2:])
        size = math.prod(shape)
        k = max(1, int(size * ratio))
        flat = tf.reshape(rings, n, size)
        idx = torch.sort(flat.abs(), dim=-1, descending=True,
                         stable=True).indices[..., :k]
        vals = flat.gather(-1, idx).contiguous()
        idx = idx.to(torch.int32).contiguous()
        scatter = _ta.topk_accumulate_ if self.use_kernels else _ta.plain
        own = flat.new_zeros((rings * n, size))
        scatter(own, idx.reshape(rings * n, k),
                             vals.reshape(rings * n, k))
        dense = flat.new_zeros((rings, size))
        scatter(dense, idx.reshape(rings, n * k),
                             vals.reshape(rings, n * k))
        total = dense.reshape((rings, 1) + shape)
        return total.expand((rings, n) + shape), \
            own.reshape((rings, n) + shape)
