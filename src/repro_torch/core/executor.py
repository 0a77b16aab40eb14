"""ExecutionPlan IR — the compiled program's runtime schedule.

The PyTorch counterpart of :mod:`repro.core.executor`.  :func:`build_plan`
derives explicit dependency edges between emitted stages from the DAG's
value ids and groups independent stages into concurrent **waves** (Kahn
levels, refined to stagger same-axis collective chains); within a wave
the plan partitions stages into per-axis **dispatch groups**
(``wave_groups``): stages sharing a mesh axis contend for that axis's
rings and serialize, stages on different axes are free to overlap.  The
plan is the reference's, stage for stage.

:func:`execute` runs the plan eagerly on PyTorch's current stream, in the
reference's issue order (round-robin across a wave's dispatch groups).
On one mesh axis that order is already the ring order every rank must
follow, so the reference's ``optimization_barrier`` edges have nothing
to pin; several axes on their own CUDA streams come with the
hierarchical slice.  Bucket-pack stages carrying an ``arena_slot`` write
into the caller's persistent arena tensors **in place** — the same
tensors come back, so there is nothing to donate.

The plan is deliberately dumb data (stage indices + edges + waves): it
duck-types against anything carrying ``in_vids``/``out_vids``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence

import torch

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


def _block(values) -> None:
    """Wait for the device work behind ``values`` (the instrument hook's
    ``block_until_ready``)."""
    for v in values:
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


def execute(plan: ExecutionPlan, args: Sequence[PyTree], *,
            arenas: Optional[Sequence] = None,
            instrument: Optional[list] = None) -> tuple:
    """Run the plan over rank-local values (inside ``with mesh:``), wave
    by wave, each wave round-robin across its dispatch groups (the
    reference's overlapped issue order).

    ``arenas`` are the persistent flat buffers for the program's bucket
    packs (one per ``arena_slot``, see
    :meth:`repro_torch.core.compiler.CompiledProgram.make_arenas`); each
    pack writes its leaves into its arena in place.  When given, returns
    ``(outputs, arenas)`` — the same arena tensors; otherwise just the
    output tuple.

    ``instrument`` is the stage-trace recorder hook: a list that receives
    one :class:`repro_torch.obs.spans.StageSpan` per executed stage, with
    ``perf_counter`` timestamps taken around a device synchronize on the
    stage's inputs and outputs.  Instrumented stages synchronize per
    stage, so the recorded run is a serial measurement.
    """
    env: dict[int, PyTree] = dict(enumerate(args))
    new_arenas = list(arenas) if arenas is not None else None
    wave_of = {i: w for w, ws in enumerate(plan.waves) for i in ws}

    def run_stage(i: int) -> tuple:
        st = plan.stages[i]
        ins = tuple(env[v] for v in st.in_vids)
        slot = getattr(st, "arena_slot", None)
        if instrument is not None:
            _block(ins)
            t0 = time.perf_counter()
        if slot is not None and new_arenas is not None:
            outs = st.run(ins, st.axis, arena=new_arenas[slot])
            new_arenas[slot] = outs[0]
        else:
            outs = st.run(ins, st.axis)
        if instrument is not None:
            _block(outs)
            span = _spans.from_stage(st, i, wave_of.get(i, 0), t0,
                                     time.perf_counter())
            instrument.append(span)
            rec = _metrics.RECORDER
            if rec.enabled:
                rec.count("exec.instrumented_stages")
                rec.observe("exec.stage_s", span.duration)
        for vid, o in zip(st.out_vids, outs):
            env[vid] = o
        return outs

    for wave, groups in zip(plan.waves, plan.dispatch_groups()):
        for i in _issue_order(groups):
            run_stage(i)
    outs = tuple(env[v] for v in plan.outputs)
    if new_arenas is not None:
        return outs, tuple(new_arenas)
    return outs
