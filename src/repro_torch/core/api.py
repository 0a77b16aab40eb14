"""CollectiveEngine — the MPI-transparency layer.

The PyTorch counterpart of :mod:`repro.core.api`.  Model / training code
talks to a :class:`CollectiveEngine`; a config flag selects which
transport runs.  Ported so far:

  * ``xla``  — passive-network baseline (one native reduction per leaf)
  * ``acis`` — explicit ring schedules (Types 1-4), every gradient sync one
    compiled switch program

The compressed and hierarchical backends (``acis_compressed``,
``acis_hierarchical``, ``acis_hierarchical_compressed``) need
``core/{compression,lookaside,fused}.py`` and raise
``NotImplementedError`` until that slice lands (ROADMAP.md, queue 1
item 2).

Where the reference runs inside a ``shard_map`` region, the port runs
inside ``with mesh:`` (a :class:`~repro_torch.mesh.LocalMesh`, or pass
``mesh=``): every gradient is rank-stacked, ``[*rank, *local]``.  The
``acis`` gradient sync is one traced program — per leaf a
``reduce(axis="auto")`` and an elementwise mean — compiled once per
pytree structure through Legalize → LowerTopology → Coalesce → FuseHops
→ SelectSchedule → Emit.  Its Coalesce bucket packs write into
persistent **arenas** in place: :meth:`CollectiveEngine.init_arenas`
allocates them once, and every :meth:`~CollectiveEngine.gradient_sync`
hands back the same tensors.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

from repro_torch import tree
from repro_torch.core import collectives, compiler, tracing
from repro_torch.core.types import ADD, TensorSpec
from repro_torch.mesh import LocalMesh, ambient, current
from repro_torch.obs import metrics as _obs

PyTree = Any

BACKENDS = ("xla", "acis", "acis_compressed", "acis_hierarchical",
            "acis_hierarchical_compressed")
PORTED_BACKENDS = ("xla", "acis")
_WAITS = ("core/{compression,lookaside,fused}.py with the compressed and "
          "hierarchical backends (ROADMAP.md, queue 1 item 2)")


def _use_kernels_default() -> bool:
    return os.environ.get("ACIS_USE_KERNELS", "") not in ("0", "false",
                                                          "False")


def live_axis_sizes(axes) -> dict:
    """``{axis: size}`` for the named axes the active mesh carries; the
    others stay absent."""
    tp = ambient()
    return {ax: tp.axis_size(ax) for ax in axes if ax in tp.axis_names}


@dataclasses.dataclass(frozen=True)
class CollectiveConfig:
    """The reference's config fields that change what the ported path
    computes or compiles; the compressed backends' codec/compressor, the
    CGRA device and the tuning DB come with their slices."""

    backend: str = "xla"
    latency_optimal_below: int = 16384  # bytes; ring-vs-latency crossover
    # Coalesce bucket size (bytes): per-leaf reductions sharing an
    # axis/monoid/codec/dtype are concatenated into flat buckets of this
    # many bytes, one collective per bucket.  None = derive from the cost
    # model's crossover for the axis traversed
    # (repro_torch.core.netmodel.bucket_bytes); 0 = disable bucketing.
    bucket_bytes: Optional[int] = None
    # hoist a bucket's shared elementwise epilogue (the gradient mean)
    # to one bucket-sized op; False keeps per-leaf epilogues.
    epilogue_hoist: bool = True
    # route the bulk data path through the hand-written CUDA kernels
    # (switchops registry): ring hop combines run kernels/fused_combine
    # and the Coalesce arena pack one kernels/pack_combine launch.  On by
    # default; $ACIS_USE_KERNELS=0 turns it off.  CPU tensors take the
    # kernels' plain versions either way.
    use_kernels: bool = dataclasses.field(
        default_factory=_use_kernels_default)
    # merge a wave's independent same-axis allreduces into ONE ring over a
    # chunk-aligned stacked buffer (bit-compatible with separate rings)
    batch_rings: bool = False
    # per-merged-launch payload cap in bytes for batch_rings; None = the
    # compiler default, 0 = uncapped
    batch_rings_bytes: Optional[int] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend {self.backend!r} not in {BACKENDS}")
        if self.backend not in PORTED_BACKENDS:
            raise NotImplementedError(
                f"backend {self.backend!r} waits for {_WAITS}")

    def cache_key(self) -> tuple:
        """Every config field a compiled program's structure depends on."""
        return dataclasses.astuple(self)


class CollectiveEngine:
    """Rank-local collective transport with backend dispatch."""

    def __init__(self, config: CollectiveConfig,
                 inner_axis: str = "data",
                 outer_axis: Optional[str] = None):
        self.config = config
        self.inner_axis = inner_axis
        self.outer_axis = outer_axis
        self._sync_cache: dict = {}   # pytree structure → CompiledProgram
        self._arena_cache: dict = {}  # (program, device, ranks) → arenas
        self._last_sync = None        # most recently built/fetched program

    def init_state(self, grads_like: PyTree) -> Optional[PyTree]:
        """Look-aside state (Type 3): None on the uncompressed backends,
        which are stateless."""
        return None

    # -- topology (the compiler's view of this engine's DP axes) -------------

    def topology(self, mesh: Optional[LocalMesh] = None, *,
                 axis_size=None) -> compiler.Topology:
        """The engine's DP axes as a compile Topology: inner axis on the
        fast intra-pod tier, outer axis (when configured and present on
        the mesh) on the thin inter-pod tier.  ``axis_size`` may be an
        int (the inner axis) or an {axis: size} mapping."""
        sizes: dict = {}
        if isinstance(axis_size, dict):
            sizes.update(axis_size)
        elif axis_size is not None:
            sizes[self.inner_axis] = axis_size
        if mesh is not None:         # the mesh is authoritative
            sizes.update(mesh.axes)
        axes = [compiler.AxisSpec(self.inner_axis,
                                  sizes.get(self.inner_axis), "ici")]
        if self.outer_axis is not None and \
                (mesh is None or self.outer_axis in mesh.axis_names):
            axes.append(compiler.AxisSpec(self.outer_axis,
                                          sizes.get(self.outer_axis), "dci"))
        return compiler.Topology(tuple(axes))

    # -- the gradient-sync transport -----------------------------------------

    def _axes(self) -> tuple:
        return (self.inner_axis,) if self.outer_axis is None \
            else (self.inner_axis, self.outer_axis)

    def gradient_sync(self, grads: PyTree, state: PyTree,
                      n_total: Optional[int] = None, *,
                      arenas: Optional[tuple] = None,
                      mesh: Optional[LocalMesh] = None):
        """Mean-all-reduce a pytree of rank-stacked gradients over the DP
        axes.

        Returns (synced_grads, new_state) — or (synced_grads, new_state,
        arenas) when ``arenas`` (from :meth:`init_arenas`) is passed: the
        Coalesce bucket packs then write the leaves into those tensors in
        place, and the same tensors come back.  Runs over ``mesh``, or the
        active mesh (``with mesh:``).  ``n_total`` overrides the divisor.
        """
        m = mesh if mesh is not None else current()
        with m:
            if self.config.backend == "xla":
                synced = tree.tree_map(lambda g: self._xla_mean(g, n_total),
                                       grads)
                return (synced, state, arenas) if arenas is not None \
                    else (synced, state)
            leaves, treedef = tree.tree_flatten(grads)
            if not leaves:             # nothing to sync
                return (grads, state, arenas) if arenas is not None \
                    else (grads, state)
            avals = tuple(TensorSpec(m.local_shape(l), l.dtype)
                          for l in leaves)
            compiled = self._sync_program(treedef, avals, n_total)
            if arenas is not None:
                _obs.RECORDER.count("arena.roundtrip")
                outs, arenas = compiled(*leaves, arenas=tuple(arenas))
            else:
                outs = compiled(*leaves)
        synced = tree.tree_unflatten(treedef, outs[:len(leaves)])
        if arenas is not None:
            return synced, state, arenas
        return synced, state

    def _xla_mean(self, g, n_total):
        tp = current()
        total = g
        n = 1
        for ax in self._axes():
            if ax in tp.axis_names:
                total = collectives.all_reduce(total, ax, ADD, backend="xla")
                n *= tp.axis_size(ax)
        return total / (n if n_total is None else n_total)

    def init_arenas(self, grads_like: PyTree, *,
                    mesh: Optional[LocalMesh] = None,
                    n_total: Optional[int] = None) -> Optional[tuple]:
        """Persistent bucket arenas for :meth:`gradient_sync` on this
        pytree of rank-stacked gradients (only shapes and dtypes are
        read), allocated once per program and mesh device and cached:
        repeated calls return the *same* tensors.  Returns None when the
        program has no bucket stages (xla backend, bucketing disabled,
        single-leaf trees)."""
        if self.config.backend == "xla":
            return None
        m = mesh if mesh is not None else current()
        leaves, treedef = tree.tree_flatten(grads_like)
        if not leaves:
            return None
        avals = tuple(TensorSpec(m.local_shape(l), l.dtype) for l in leaves)
        with m:
            compiled = self._sync_program(treedef, avals, n_total)
        key = (compiled, str(m.device), m.rank_shape)
        hit = self._arena_cache.get(key)
        if hit is None:
            hit = self._arena_cache[key] = compiled.make_arenas(m)
            if hit is not None:
                _obs.RECORDER.count("arena.alloc")
        return hit

    def _sync_program(self, treedef, avals: tuple,
                      n_total: Optional[int] = None):
        """Build (or fetch) the compiled gradient-sync switch program for
        one pytree structure; axis sizes come from the active mesh."""
        cfg = self.config
        sizes = live_axis_sizes(self._axes())
        # the sizes are part of the key: the same engine may serve meshes
        # of different DP size, and the schedule choice depends on them
        key = (treedef, avals, n_total, tuple(sorted(sizes.items())),
               cfg.cache_key())
        hit = self._sync_cache.get(key)
        if hit is not None:
            _obs.RECORDER.count("compile.cache_hit")
            self._last_sync = hit
            return hit
        _obs.RECORDER.count("compile.cache_miss")
        compiled = self._build_sync(cfg, avals, n_total, sizes)
        self._sync_cache[key] = compiled
        self._last_sync = compiled
        return compiled

    def _build_sync(self, cfg, avals, n_total, sizes):
        """Trace + compile the gradient-sync program under ``cfg``."""
        inner, outer = self.inner_axis, self.outer_axis
        n_leaves = len(avals)

        def _mean(y):
            n = n_total
            if n is None:
                tp = ambient()
                n = tp.axis_size(inner)
                if outer is not None:
                    n = n * tp.axis_size(outer)
            return y / n

        def sync(*gs):
            outs = []
            for g in gs:
                red = tracing.reduce(g, ADD, axis="auto")
                outs.append(tracing.map(_mean, red, name="mean",
                                        elementwise=True))
            return tuple(outs)

        prog = tracing.trace(
            sync, name=f"gradient_sync[{cfg.backend}x{n_leaves}]",
            num_inputs=n_leaves)
        return compiler.compile_rank_local(
            prog, inner, axis_size=sizes.get(inner), config=cfg,
            in_avals=avals, topology=self.topology(axis_size=sizes))

    def last_sync_program(self):
        """The most recently compiled (or cache-hit) gradient-sync
        :class:`~repro_torch.core.compiler.CompiledProgram`, or None
        before the first sync."""
        return self._last_sync

    # -- switch-program compilation (the one entry point) --------------------

    def compile(self, prog, mesh: Optional[LocalMesh] = None,
                in_specs=None, out_specs=None, *,
                axis_name: Optional[str] = None, in_avals=None,
                axis_size=None):
        """Compile a switch program through the pass pipeline.

        ``prog`` may be a plain Python function over traced values (see
        :mod:`repro_torch.core.tracing`), a traced
        :class:`~repro_torch.core.program.DagProgram`, or a legacy chain
        :class:`~repro_torch.core.program.SwitchProgram`.  With ``mesh``
        (plus in/out specs, e.g. ``P("data")`` / ``P(None)``) the result
        is a callable on global tensors; without it, a rank-local
        :class:`~repro_torch.core.compiler.CompiledProgram` to run inside
        ``with mesh:``.  ``in_avals`` (local shapes, one per program
        input) give the scheduler payload sizes.
        """
        ax = axis_name or self.inner_axis
        topo = self.topology(mesh, axis_size=axis_size)
        if isinstance(axis_size, dict):
            axis_size = axis_size.get(ax)
        if mesh is None:
            return compiler.compile_rank_local(
                prog, ax, axis_size=axis_size, config=self.config,
                in_avals=in_avals, topology=topo)
        if in_specs is None or out_specs is None:
            raise ValueError("mesh compilation needs in_specs and out_specs")
        return compiler.compile_program(
            prog, mesh, ax, in_specs, out_specs, config=self.config,
            in_avals=in_avals, topology=topo)


def make_engine(backend: str = "xla", *, inner_axis: str = "data",
                outer_axis: Optional[str] = None, **kw) -> CollectiveEngine:
    return CollectiveEngine(CollectiveConfig(backend=backend, **kw),
                            inner_axis=inner_axis, outer_axis=outer_axis)
