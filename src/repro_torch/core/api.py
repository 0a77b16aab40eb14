"""CollectiveEngine — the MPI-transparency layer.

The PyTorch counterpart of :mod:`repro.core.api`.  Model / training code
talks to a :class:`CollectiveEngine`; a config flag selects which
transport runs.  Ported so far:

  * ``xla``             — passive-network baseline (one native reduction
                          per leaf)
  * ``acis``            — explicit ring schedules (Types 1-4), every
                          gradient sync one compiled switch program
  * ``acis_compressed`` — acis + Type 2/3 wire compression with error
                          feedback (``compressor`` ``int8``,
                          ``int8_hopquant`` or ``topk``): the residuals
                          from :meth:`CollectiveEngine.init_state` are
                          threaded through every sync
  * ``acis_hierarchical`` (+ ``_compressed``) — pod-aware two-level sync
                          on a two-axis mesh (``outer_axis="pod"``):
                          LowerTopology turns the ``axis="auto"`` reduce
                          into RS(inner) → AR(outer) → AG(inner), and a
                          compressed engine's ``codec`` rides the thin
                          outer hop of any plain reduce it compiles

:meth:`CollectiveEngine.compile` is the one entry point for any other
switch program, the Type 3/4 ones included: a traced program compiles
through the pass pipeline to stages such as ``scan+allgather`` (Fig. 5,
whose local scan is the ``prefix_sum`` kernel under ``use_kernels``),
``allreduce+alltoall`` (NAS IS), ``map+reduce_scatter`` and
``allgather+map``, and look-aside operators (``core/lookaside.py``)
ride in ``map`` bodies.

Where the reference runs inside a ``shard_map`` region, the port runs
inside ``with mesh:`` (a :class:`~repro_torch.mesh.LocalMesh`, or pass
``mesh=``): every gradient is rank-stacked, ``[*rank, *local]``.  The
``acis*`` gradient sync is one traced program — per leaf a
``reduce(axis="auto")`` and an elementwise mean, with an error-feedback
target/residual around it on ``acis_compressed`` — compiled once per
pytree structure through Legalize → LowerTopology → Coalesce → FuseHops
→ SelectSchedule → PlaceCGRA → Emit.  Its Coalesce bucket packs write
into persistent **arenas** in place: :meth:`CollectiveEngine.init_arenas`
allocates them once, and every :meth:`~CollectiveEngine.gradient_sync`
hands back the same tensors.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch

from repro_torch import tree
from repro_torch.core import collectives, compiler, tracing
from repro_torch.core.lookaside import init_residual
from repro_torch.core.types import ADD, TensorSpec
from repro_torch.mesh import LocalMesh, ambient, current
from repro_torch.obs import metrics as _obs

PyTree = Any

BACKENDS = ("xla", "acis", "acis_compressed", "acis_hierarchical",
            "acis_hierarchical_compressed")


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
    computes or compiles; the tuning DB comes with its slice."""

    backend: str = "xla"
    # wire codec a compressed engine puts on the thin outer hop of a
    # plain reduce: int8 | bf16 | fp8 (repro_torch.core.wire.resolve_codec)
    codec: str = "int8"
    # compressor for error-feedback sync: int8 | int8_hopquant | topk
    compressor: str = "int8"
    topk_ratio: float = 0.01
    latency_optimal_below: int = 16384  # bytes; ring-vs-latency crossover
    # Coalesce bucket size (bytes): per-leaf reductions sharing an
    # axis/monoid/codec/dtype are concatenated into flat buckets of this
    # many bytes, one collective per bucket.  None = derive from the cost
    # model's crossover for the axis traversed
    # (repro_torch.core.netmodel.bucket_bytes); 0 = disable bucketing.
    bucket_bytes: Optional[int] = None
    # switch CGRA the PlaceCGRA pass maps stage bodies onto; None = the
    # paper's Table II device (repro_torch.cgra.device.PAPER_CGRA)
    cgra_device: Optional[Any] = None
    # overlapped wave dispatch (repro_torch.core.executor.execute): on
    # CUDA tensors the per-axis dispatch groups of a wave that spans
    # several axes run on their own stream, one per mesh axis.  False =
    # strict stage order on the caller's stream (kept for A/B
    # measurement).
    overlap_dispatch: bool = True
    # hoist a bucket's shared elementwise epilogue (the gradient mean)
    # to one bucket-sized op; False keeps per-leaf epilogues.
    epilogue_hoist: bool = True
    # route the bulk data path through the hand-written CUDA kernels
    # (switchops registry): ring hop combines run kernels/fused_combine,
    # the Coalesce arena pack one kernels/pack_combine launch, and the
    # compressed hops kernels/quant_combine (int8_hopquant) or
    # kernels/topk_accum (topk).  On by default; $ACIS_USE_KERNELS=0
    # turns it off.  CPU tensors take the kernels' plain versions either
    # way.
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

    def cache_key(self) -> tuple:
        """Every config field a compiled program's structure depends on
        (the reference's key, plus the CGRA device the placements were
        made for)."""
        return (self.backend, self.codec, self.compressor,
                self.topk_ratio, self.latency_optimal_below,
                self.bucket_bytes, self.cgra_device, self.overlap_dispatch,
                self.epilogue_hoist, self.use_kernels,
                self.batch_rings, self.batch_rings_bytes)


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

    @property
    def compressed(self) -> bool:
        return "compressed" in self.config.backend

    @property
    def hierarchical(self) -> bool:
        return "hierarchical" in self.config.backend

    @property
    def base_backend(self) -> str:
        return "xla" if self.config.backend == "xla" else "acis"

    def init_state(self, grads_like: PyTree) -> Optional[PyTree]:
        """Look-aside state (Type 3): error-feedback residuals, or None.

        On ``acis_compressed``, f32 zeros shaped like the rank-stacked
        ``grads_like`` on its devices; the uncompressed backends are
        stateless and return None."""
        if self.compressed:
            return init_residual(grads_like, torch.float32)
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

        On ``acis_compressed`` ``state`` is the residual pytree (from
        :meth:`init_state`, then each sync's ``new_state``): its leaves
        are extra program inputs, and the new residuals come back as
        ``new_state``.
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
            args = tuple(leaves)
            if self.compressed:
                res, res_def = tree.tree_flatten(state)
                if res_def != treedef:
                    raise ValueError("the residual state must have the "
                                     "gradients' tree structure")
                args = args + tuple(res)
            if arenas is not None:
                _obs.RECORDER.count("arena.roundtrip")
                outs, arenas = compiled(*args, arenas=tuple(arenas))
            else:
                outs = compiled(*args)
        synced = tree.tree_unflatten(treedef, outs[:len(leaves)])
        if self.compressed:
            state = tree.tree_unflatten(treedef, outs[len(leaves):])
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
        """Trace + compile the gradient-sync program under ``cfg``.

        On ``acis_compressed`` each leaf runs the error-feedback triple
        around one ``ef_reduce``: the target ``g + r`` in the gradient's
        dtype, the mean of the lossy total, and the new residual
        ``t - delivered`` in the residual's dtype (the reference's
        dtype rules)."""
        inner, outer = self.inner_axis, self.outer_axis
        compressed = self.compressed
        n_leaves = len(avals)

        def _mean(y):
            n = n_total
            if n is None:
                tp = ambient()
                n = tp.axis_size(inner)
                if outer is not None:
                    n = n * tp.axis_size(outer)
            return y / n

        def _ef_target(g, r):
            return g + r.to(g.dtype)

        def _ef_residual(t, delivered, r):
            return (t.to(torch.float32) - delivered).to(r.dtype)

        def sync(*args):
            gs, rs = args[:n_leaves], args[n_leaves:]
            outs, news = [], []
            for i, g in enumerate(gs):
                if compressed:
                    t = tracing.map(_ef_target, g, rs[i], name="ef_target")
                    red, dlv = tracing.ef_reduce(
                        t, compressor=cfg.compressor,
                        topk_ratio=cfg.topk_ratio, axis="auto")
                else:
                    red = tracing.reduce(g, ADD, axis="auto")
                outs.append(tracing.map(_mean, red, name="mean",
                                        elementwise=True))
                if compressed:
                    news.append(tracing.map(_ef_residual, t, dlv, rs[i],
                                            name="ef_residual"))
            return tuple(outs) + tuple(news)

        prog = tracing.trace(
            sync, name=f"gradient_sync[{cfg.backend}x{n_leaves}]",
            num_inputs=n_leaves * (2 if compressed else 1))
        # the residual inputs are sized by the gradient avals, as in the
        # reference (its in_avals are avals + avals)
        in_avals = avals + (avals if compressed else ())
        return compiler.compile_rank_local(
            prog, inner, axis_size=sizes.get(inner), config=cfg,
            in_avals=in_avals, topology=self.topology(axis_size=sizes))

    def last_sync_program(self):
        """The most recently compiled (or cache-hit) gradient-sync
        :class:`~repro_torch.core.compiler.CompiledProgram`, or None
        before the first sync."""
        return self._last_sync

    # -- generic ops (Type 1, rank-local over one axis) ----------------------

    def all_reduce(self, x, axis_name=None, monoid=ADD):
        return collectives.all_reduce(
            x, axis_name or self.inner_axis, monoid,
            backend=self.base_backend)

    def all_gather(self, x, axis_name=None):
        return collectives.all_gather(
            x, axis_name or self.inner_axis, backend=self.base_backend)

    def reduce_scatter(self, x, axis_name=None, monoid=ADD):
        return collectives.reduce_scatter(
            x, axis_name or self.inner_axis, monoid,
            backend=self.base_backend)

    def all_to_all(self, x, axis_name=None):
        return collectives.all_to_all(
            x, axis_name or self.inner_axis, backend=self.base_backend)

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
