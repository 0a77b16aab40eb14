"""ExecutionPlan IR — the compiled program's runtime schedule.

The PyTorch counterpart of :mod:`repro.core.executor`.  :func:`build_plan`
derives explicit dependency edges between emitted stages from the DAG's
value ids and groups independent stages into concurrent **waves** (Kahn
levels, refined to stagger same-axis collective chains); within a wave
the plan partitions stages into per-axis **dispatch groups**
(``wave_groups``): stages sharing a mesh axis contend for that axis's
rings and serialize, stages on different axes are free to overlap.  The
plan is the reference's, stage for stage.

:func:`execute` runs the plan eagerly, wave by wave.  Overlapped (the
default) it issues a wave round-robin across its dispatch groups, the
reference's order; where the wave spans several mesh axes and the values
live on the card, each axis group runs on a CUDA stream of its own (one
per mesh axis, kept on the plan), so collectives on different axes may
run at once.  That is the port's form of the reference's
``optimization_barrier`` edges: a stream runs its stages in issue order
(the chain every rank must follow on one ring), and nothing orders two
streams inside a wave.  Each such wave forks from the caller's stream
and joins it again before the next wave, so every dependency, which
always crosses a wave, is ordered by an event.  Serial dispatch
(``overlapped=False``) runs the stages in plan order on the caller's
stream.  Bucket-pack stages carrying an ``arena_slot`` write into the
caller's persistent arena tensors **in place** — the same tensors come
back, so there is nothing to donate.

The plan is deliberately dumb data (stage indices + edges + waves): it
duck-types against anything carrying ``in_vids``/``out_vids``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence

import torch

from repro_torch import tree as _tree
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import spans as _spans

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Dependency-explicit schedule over a compiled program's stages.

    ``deps[i]`` are the stage indices stage *i* consumes values from;
    ``waves`` partitions ``range(len(stages))`` into concurrency groups
    in topological order; ``wave_groups[w]`` splits wave ``w`` into
    per-axis dispatch groups ``(axis, stage_indices)`` — stages within a
    group share a mesh axis (or are axis-less local compute) and
    serialize, groups are mutually independent.  ``stages`` is the same
    sequence the owning ``CompiledProgram`` holds (kept here so the cost
    model and the simulator can walk the plan alone).
    """

    stages: tuple
    num_inputs: int
    outputs: tuple[int, ...]
    deps: tuple[tuple[int, ...], ...]
    waves: tuple[tuple[int, ...], ...]
    wave_groups: tuple[tuple[tuple[str, tuple[int, ...]], ...], ...] = ()
    # the CUDA streams overlapped dispatch runs axis groups on, by
    # (device, axis); made on first use
    streams: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def n_waves(self) -> int:
        return len(self.waves)

    def wave_of(self, stage_index: int) -> int:
        for w, group in enumerate(self.waves):
            if stage_index in group:
                return w
        raise IndexError(stage_index)

    def validate(self) -> None:
        """Every stage appears in exactly one wave, strictly after all of
        its dependencies' waves; wave_groups re-partition each wave."""
        seen: dict[int, int] = {}
        for w, group in enumerate(self.waves):
            for i in group:
                if i in seen:
                    raise ValueError(f"stage {i} scheduled twice")
                seen[i] = w
        if len(seen) != len(self.stages):
            raise ValueError("waves do not cover every stage")
        for i, ds in enumerate(self.deps):
            for d in ds:
                if seen[d] >= seen[i]:
                    raise ValueError(
                        f"stage {i} (wave {seen[i]}) depends on stage {d} "
                        f"(wave {seen[d]}) — waves are not topological")
        for wave, groups in zip(self.waves, self.dispatch_groups()):
            flat = sorted(i for _, idxs in groups for i in idxs)
            if flat != sorted(wave):
                raise ValueError(
                    f"wave_groups {groups} do not partition wave {wave}")

    def stream(self, device: torch.device, axis: str):
        """The plan's CUDA stream for ``axis`` on ``device``."""
        key = (device.index, axis)
        s = self.streams.get(key)
        if s is None:
            s = self.streams[key] = torch.cuda.Stream(device)
        return s

    def dispatch_groups(self) -> tuple:
        """The per-wave axis dispatch groups — the stored ``wave_groups``
        when present, else derived on the fly (a plan built by hand with
        just stages/waves still dispatches correctly instead of silently
        running nothing)."""
        if len(self.wave_groups) == len(self.waves):
            return self.wave_groups
        return tuple(_axis_groups(self.stages, w) for w in self.waves)


def _axis_groups(stages: Sequence,
                 wave: tuple[int, ...]) -> tuple[tuple[str, tuple[int, ...]],
                                                 ...]:
    """Partition one wave into per-axis dispatch groups.

    Stages sharing a (non-empty) axis contend for that axis's rings and
    form one serialized group, in plan order.  Axis-less stages (local
    maps) are each their own singleton group — nothing serializes free
    compute.

    Within an axis group, batched ring launches (``batched_allreduce``)
    are issued first: the merged ring is the group's long pole, and
    leading with it lets the leftover per-program launches hide behind
    it.  Stages within one wave are mutually independent (same Kahn
    level), so the stable reorder cannot break a dependency.
    """
    by_axis: dict[str, list[int]] = {}
    groups: list[tuple[str, tuple[int, ...]]] = []
    for i in wave:
        ax = getattr(stages[i], "axis", "")
        if not ax:
            groups.append(("", (i,)))
            continue
        if ax not in by_axis:
            by_axis[ax] = []
            groups.append((ax, by_axis[ax]))  # placeholder; fixed below
        by_axis[ax].append(i)

    def batched_first(idxs):
        return tuple(sorted(
            idxs,
            key=lambda i: getattr(stages[i], "kind", "")
            != "batched_allreduce"))

    return tuple((ax, batched_first(idxs) if isinstance(idxs, list)
                  else idxs)
                 for ax, idxs in groups)


def _pipeline_levels(stages: Sequence, deps: Sequence[tuple[int, ...]],
                     levels: list[int]) -> list[int]:
    """Software-pipeline same-axis collective chains.

    Two topology-preserving refinements over the plain Kahn (ASAP)
    levels — symmetric bucket chains (pack -> ring -> epilogue per
    bucket, all on one axis) otherwise schedule all packs together, all
    rings together and all epilogues together, so no map ever hides
    under a ring:

      * a wave whose collectives all share ONE axis serializes on that
        axis's rings anyway (zero concurrency) — the extras slide to
        later waves, staggering the chains.  Waves holding collectives
        on several axes are left alone: their cross-axis overlap is the
        thing the tier model rewards, and splitting them would forfeit
        it;
      * an axis-less stage (local compute) with a consumer slides down
        to the wave just before its earliest consumer, landing next to
        the staggered collective it can hide under.  Output maps keep
        their ASAP slot.
    """
    n = len(stages)

    def axis(i: int) -> str:
        return getattr(stages[i], "axis", "") or ""

    for _ in range(n):
        # re-settle the dependency floor (stage order is topological)
        for i in range(n):
            if deps[i]:
                levels[i] = max(levels[i],
                                1 + max(levels[d] for d in deps[i]))
        by_wave: dict[int, list[int]] = {}
        for i in range(n):
            if axis(i):
                by_wave.setdefault(levels[i], []).append(i)
        moved = False
        for lv in sorted(by_wave):
            idxs = by_wave[lv]
            if len(idxs) < 2 or len({axis(i) for i in idxs}) != 1:
                continue
            for i in idxs[1:]:
                levels[i] += 1
            moved = True
            break
        if not moved:
            break

    consumers: list[list[int]] = [[] for _ in range(n)]
    for i in range(n):
        for d in deps[i]:
            consumers[d].append(i)
    for i in range(n - 1, -1, -1):
        if axis(i) or not consumers[i]:
            continue
        tgt = min(levels[c] for c in consumers[i]) - 1
        if tgt > levels[i]:
            levels[i] = tgt

    # compress any emptied levels
    remap = {lv: w for w, lv in enumerate(sorted(set(levels)))}
    return [remap[lv] for lv in levels]


def build_plan(stages: Sequence, num_inputs: int,
               outputs: tuple[int, ...]) -> ExecutionPlan:
    """Derive the dependency edges and concurrency waves for ``stages``.

    A stage depends on the stage producing each of its input values;
    values below ``num_inputs`` are program inputs (no producer).  Wave
    assignment starts from the Kahn level (1 + the max level of any
    dependency) and is then refined by :func:`_pipeline_levels` to
    stagger same-axis collective chains.
    """
    producer: dict[int, int] = {}
    for i, st in enumerate(stages):
        for v in st.out_vids:
            if v in producer:
                raise ValueError(
                    f"value {v} produced by stage {producer[v]} and "
                    f"stage {i} — the stage list is not single-assignment")
            producer[v] = i
    deps: list[tuple[int, ...]] = []
    levels: list[int] = []
    for i, st in enumerate(stages):
        ds = sorted({producer[v] for v in st.in_vids if v in producer})
        deps.append(tuple(ds))
        levels.append(1 + max((levels[d] for d in ds), default=-1))
    levels = _pipeline_levels(stages, deps, levels)
    n_waves = (max(levels) + 1) if levels else 0
    waves = tuple(tuple(i for i, l in enumerate(levels) if l == w)
                  for w in range(n_waves))
    wave_groups = tuple(_axis_groups(stages, w) for w in waves)
    plan = ExecutionPlan(tuple(stages), num_inputs, tuple(outputs),
                         tuple(deps), waves, wave_groups)
    plan.validate()
    return plan


def _issue_order(groups) -> list[int]:
    """Round-robin across a wave's dispatch groups: the k-th stage of
    every axis group is issued before any group's (k+1)-th, so
    different-axis collectives sit adjacent and can overlap."""
    order: list[int] = []
    cursors = [list(idxs) for _, idxs in groups]
    while any(cursors):
        for c in cursors:
            if c:
                order.append(c.pop(0))
    return order


def _tensors(values) -> list:
    return [t for t in _tree.tree_leaves(values)
            if isinstance(t, torch.Tensor)]


def _cuda_device(values) -> Optional[torch.device]:
    for t in _tensors(values):
        if t.is_cuda:
            return t.device
    return None


def execute(plan: ExecutionPlan, args: Sequence[PyTree], *,
            arenas: Optional[Sequence] = None,
            overlapped: bool = True,
            instrument: Optional[list] = None) -> tuple:
    """Run the plan over rank-local values (inside ``with mesh:``), wave
    by wave.

    ``overlapped=True`` (the default) issues each wave round-robin across
    its dispatch groups (the reference's overlapped issue order).  When
    the wave holds more than one axis group and the values are on the
    card, each axis group runs on the plan's stream for that axis: the
    side streams first wait for the caller's stream, every tensor a
    stage reads there is marked as in use by that stream
    (``record_stream``) and every tensor it makes as in use by the
    caller's, so the caching allocator reuses no block another stream
    may still read; the caller's stream waits for them all before the
    next wave, and so before ``execute`` returns.  Axis-less groups
    (local maps) stay on the caller's stream.  ``overlapped=False`` runs
    the stages in plan order on the caller's stream (the reference's
    serial emission).  On the CPU both modes issue on the one host
    thread, in their order.

    ``arenas`` are the persistent flat buffers for the program's bucket
    packs (one per ``arena_slot``, see
    :meth:`repro_torch.core.compiler.CompiledProgram.make_arenas`); each
    pack writes its leaves into its arena in place.  When given, returns
    ``(outputs, arenas)`` — the same arena tensors; otherwise just the
    output tuple.

    ``instrument`` is the stage-trace recorder hook: a list that receives
    one :class:`repro_torch.obs.spans.StageSpan` per executed stage, in
    dispatch order.  Which clock a span carries depends on where the values
    live:

      * **on the card**: device time.  Each stage records a
        ``torch.cuda.Event`` pair on the stream it runs on (the caller's,
        or its axis stream in a multi-axis wave); ``execute`` synchronizes
        once at the end and sets each span's ``t_start``/``t_end`` (in
        seconds) from ``elapsed_time`` relative to the first stage's start
        event.  Nothing synchronizes per stage, so the stages keep their
        overlap and the recording does not serialize the program;
      * **on the CPU**: host ``time.perf_counter`` seconds around each
        stage (the host runs the stages one after another).

    While the process recorder keeps a span log (``obs.recording(spans=
    True)``) each stage runs under ``obs.spans.span("stage." +
    stage.label)`` and counts ``sync.stages.<label>``; that path
    synchronises nothing.
    """
    rec = _metrics.RECORDER
    spans_on = rec.spans is not None
    env: dict[int, PyTree] = dict(enumerate(args))
    new_arenas = list(arenas) if arenas is not None else None
    wave_of = {i: w for w, ws in enumerate(plan.waves) for i in ws}
    device = _cuda_device(args) if overlapped else None
    # the instrument's clock: CUDA events on the card, perf_counter on the
    # host (see the docstring)
    timer = _cuda_device(args) if instrument is not None else None
    events: list = []               # (stage, start event, end event)

    def record(i: int, t0: float, t1: float) -> None:
        span = _spans.from_stage(plan.stages[i], i, wave_of.get(i, 0),
                                 t0, t1)
        instrument.append(span)
        if rec.enabled:
            rec.count("exec.instrumented_stages")
            rec.observe("exec.stage_s", span.duration)

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(timer))
        return ev

    def run_stage(i: int) -> tuple:
        st = plan.stages[i]
        ins = tuple(env[v] for v in st.in_vids)
        slot = getattr(st, "arena_slot", None)
        if instrument is not None:
            if timer is not None:
                e0 = mark()
            else:
                t0 = time.perf_counter()
        if spans_on:
            rec.count("sync.stages." + st.label)
            region = _spans.span("stage." + st.label)
        else:
            region = _spans.NOOP
        with region:
            if slot is not None and new_arenas is not None:
                outs = st.run(ins, st.axis, arena=new_arenas[slot])
                new_arenas[slot] = outs[0]
            else:
                outs = st.run(ins, st.axis)
        if instrument is not None:
            if timer is not None:
                events.append((i, e0, mark()))
            else:
                record(i, t0, time.perf_counter())
        for vid, o in zip(st.out_vids, outs):
            env[vid] = o
        return outs

    def run_on(stream, caller, i: int) -> None:
        st = plan.stages[i]
        for t in _tensors([env[v] for v in st.in_vids]):
            if t.is_cuda:
                t.record_stream(stream)
        with torch.cuda.stream(stream):
            outs = run_stage(i)
        for t in _tensors(outs):
            if t.is_cuda:
                t.record_stream(caller)

    for wave, groups in zip(plan.waves, plan.dispatch_groups()):
        if not overlapped:
            for i in wave:
                run_stage(i)
            continue
        n_axes = sum(1 for ax, _ in groups if ax)
        if device is None or n_axes < 2:
            for i in _issue_order(groups):
                run_stage(i)
            continue
        caller = torch.cuda.current_stream(device)
        forked = {}
        for ax, _ in groups:
            if ax and ax not in forked:
                forked[ax] = plan.stream(device, ax)
                forked[ax].wait_stream(caller)
        for i in _issue_order(groups):
            ax = plan.stages[i].axis
            if ax:
                run_on(forked[ax], caller, i)
            else:
                run_stage(i)
        for s in forked.values():
            caller.wait_stream(s)
    if events:
        torch.cuda.synchronize(timer)
        origin = events[0][1]
        for i, e0, e1 in events:
            record(i, origin.elapsed_time(e0) / 1e3,
                   origin.elapsed_time(e1) / 1e3)
    outs = tuple(env[v] for v in plan.outputs)
    if new_arenas is not None:
        return outs, tuple(new_arenas)
    return outs
