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

Bounded-staleness sync: ``gradient_sync(membership=...)`` masks dead
ranks out of the reduction and renormalizes by the live count (a
:class:`repro_torch.elastic.Membership`, a per-rank mask, or the
rank-stacked alive flags); the mask is a runtime program input, so
membership flips never recompile, and :meth:`CollectiveEngine.recompile`
reports what a topology change reuses.  ``CollectiveConfig(autotune=
True)`` resolves the tunable config fields through the tuning DB
(:mod:`repro_torch.tune`) at compile.
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


def live_axis_sizes(axes, known: Optional[dict] = None) -> dict:
    """``{axis: size}`` for the named axes: ``known`` entries as given,
    the rest read from the active mesh; axes bound nowhere stay
    absent."""
    sizes = dict(known) if known else {}
    tp = ambient()
    for ax in axes:
        if ax is None or ax in sizes:
            continue
        if ax in tp.axis_names:
            sizes[ax] = tp.axis_size(ax)
    return sizes


@dataclasses.dataclass(frozen=True)
class RecompileReport:
    """What :meth:`CollectiveEngine.recompile` reused vs rebuilt.

    Shape-preserving topology deltas (rank dropout absorbed by the alive
    mask, ×k link degradation) must report 100% reuse: the mask is a
    runtime program input, so membership flips never retrace, and the
    arenas are keyed by compiled-program identity.
    """

    programs_reused: int = 0
    programs_rebuilt: int = 0
    arenas_reused: int = 0
    arenas_rebuilt: int = 0
    shape_preserving: bool = True

    @property
    def full_recompile(self) -> bool:
        return self.programs_rebuilt > 0

    @property
    def reuse_frac(self) -> float:
        total = (self.programs_reused + self.programs_rebuilt
                 + self.arenas_reused + self.arenas_rebuilt)
        if total == 0:
            return 1.0
        return (self.programs_reused + self.arenas_reused) / total


@dataclasses.dataclass(frozen=True)
class CollectiveConfig:
    """The reference's config fields that change what the ported path
    computes or compiles, and the tuning-DB switches."""

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
    # consult (and on a miss, populate) the on-disk tuning DB
    # (repro_torch.tune.search) at compile: the stored winning overrides
    # for this (program structure, topology) are applied transparently.
    autotune: bool = False
    # tuning-DB path; None = $ACIS_TUNE_DB, else ./.acis_tune_torch.json
    tune_db: Optional[str] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend {self.backend!r} not in {BACKENDS}")

    def cache_key(self) -> tuple:
        """Every config field a compiled program's structure depends on
        (the reference's key, plus the CGRA device the placements were
        made for).  ``autotune`` and ``tune_db`` stay out: the tuned
        fields they resolve are in it."""
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
        self._tune_cache: dict = {}   # pytree structure → tuned config
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

    def _local_alive(self, membership) -> torch.Tensor:
        """The rank-stacked alive flags (float32, shape ``rank_shape`` on
        the mesh's device) from a membership view: a
        :class:`repro_torch.elastic.Membership`, a length-``n_ranks`` mask
        (rank = ``outer_index * |inner| + inner_index``), a tensor already
        shaped like the rank dims, or one flag for every rank.  The
        flags are a runtime program input: membership flips never
        recompile."""
        tp = current()
        if hasattr(membership, "mask_array"):
            mask = membership.mask_array(torch.float32)
        else:
            mask = torch.as_tensor(membership, dtype=torch.float32)
        mask = mask.to(device=getattr(tp, "device", mask.device),
                       dtype=torch.float32)
        if tuple(mask.shape) == tp.rank_shape:
            return mask
        if mask.dim() == 0:
            return mask.expand(tp.rank_shape).contiguous()
        idx = tp.axis_index(self.inner_axis)
        if self.outer_axis is not None and \
                self.outer_axis in tp.axis_names:
            idx = idx + tp.axis_size(self.inner_axis) \
                * tp.axis_index(self.outer_axis)
        return mask.reshape(-1)[idx].expand(tp.rank_shape).contiguous()

    def gradient_sync(self, grads: PyTree, state: PyTree,
                      n_total: Optional[int] = None, *,
                      arenas: Optional[tuple] = None,
                      mesh: Optional[LocalMesh] = None,
                      membership=None):
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

        ``membership`` switches to bounded-staleness sync: dead ranks'
        contributions are masked to the monoid identity and the mean is
        renormalized by the live count, which rides in the *same* flat
        ring buffer as the payload (``tracing.masked_reduce``).  It takes
        what :meth:`_local_alive` takes; the mask is a runtime input, so
        changing it never recompiles.  ``n_total`` is ignored on the
        masked path — the live count is the divisor.  The ``xla`` backend
        reduces the masked payload and the count in two launches.
        """
        m = mesh if mesh is not None else current()
        with m:
            if self.config.backend == "xla":
                if membership is not None:
                    alive = self._local_alive(membership)
                    synced = tree.tree_map(
                        lambda g: self._xla_masked_mean(g, alive), grads)
                else:
                    synced = tree.tree_map(
                        lambda g: self._xla_mean(g, n_total), grads)
                return (synced, state, arenas) if arenas is not None \
                    else (synced, state)
            leaves, treedef = tree.tree_flatten(grads)
            if not leaves:             # nothing to sync
                return (grads, state, arenas) if arenas is not None \
                    else (grads, state)
            avals = tuple(TensorSpec(m.local_shape(l), l.dtype)
                          for l in leaves)
            compiled = self._sync_program(treedef, avals, n_total,
                                          masked=membership is not None)
            args = tuple(leaves)
            if self.compressed:
                res, res_def = tree.tree_flatten(state)
                if res_def != treedef:
                    raise ValueError("the residual state must have the "
                                     "gradients' tree structure")
                args = args + tuple(res)
            if membership is not None:
                args = args + (self._local_alive(membership),)
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

    def _xla_masked_mean(self, g, alive):
        """The passive-network masked mean: the masked payload and the
        live count reduced in two launches (the reference's oracle for
        the compiled one-ring path)."""
        tp = current()
        axes = [ax for ax in self._axes() if ax in tp.axis_names]
        count = alive
        total = torch.where(tp.rank_bcast(alive != 0, g), g,
                            torch.zeros_like(g))
        for ax in axes:
            count = collectives.all_reduce(count, ax, ADD, backend="xla")
            total = collectives.all_reduce(total, ax, ADD, backend="xla")
        count = torch.clamp_min(count, 1.0)
        return total / tp.rank_bcast(count.to(g.dtype), g)

    def init_arenas(self, grads_like: PyTree, *,
                    mesh: Optional[LocalMesh] = None,
                    n_total: Optional[int] = None,
                    axis_sizes: Optional[dict] = None,
                    masked: bool = False) -> Optional[tuple]:
        """Persistent bucket arenas for :meth:`gradient_sync` on this
        pytree of rank-stacked gradients (only shapes and dtypes are
        read), allocated once per program and mesh device and cached:
        repeated calls return the *same* tensors.  Returns None when the
        program has no bucket stages (xla backend, bucketing disabled,
        single-leaf trees).  ``axis_sizes`` overrides the mesh's axis
        sizes for the program; ``masked`` selects the bounded-staleness
        program (``gradient_sync(membership=...)``)."""
        if self.config.backend == "xla":
            return None
        m = mesh if mesh is not None else current()
        leaves, treedef = tree.tree_flatten(grads_like)
        if not leaves:
            return None
        avals = tuple(TensorSpec(m.local_shape(l), l.dtype) for l in leaves)
        with m:
            compiled = self._sync_program(treedef, avals, n_total,
                                          axis_sizes=axis_sizes,
                                          masked=masked)
        key = (compiled, str(m.device), m.rank_shape)
        hit = self._arena_cache.get(key)
        if hit is None:
            hit = self._arena_cache[key] = compiled.make_arenas(m)
            if hit is not None:
                _obs.RECORDER.count("arena.alloc")
        return hit

    def recompile(self, delta, grads_like: PyTree, *,
                  mesh: Optional[LocalMesh] = None,
                  axis_sizes: Optional[dict] = None,
                  n_total: Optional[int] = None,
                  masked: bool = True) -> RecompileReport:
        """Re-resolve the compiled sync program and arenas after a
        topology change (a :class:`repro_torch.elastic.TopologyDelta` or
        any object with ``shape_preserving`` / ``axis_sizes``
        attributes), for rank-stacked ``grads_like`` on ``mesh`` (or the
        active mesh).

        Shape-preserving deltas — rank dropout absorbed by the alive
        mask, ×k link-tier degradation — MUST hit the existing caches:
        the mask is a runtime input (not part of any compile key) and
        arenas are keyed by compiled-program identity, so both report
        100% reuse.  Only a delta that moves rank-local shapes
        (``axis_sizes`` set) compiles a fresh program and allocates
        fresh arenas.

        The returned :class:`RecompileReport` carries the reuse/rebuild
        counters; they are also emitted to ``obs``
        (``recompile.programs_reused`` etc., and the ``engine.recompile``
        event).
        """
        leaves, treedef = tree.tree_flatten(grads_like)
        if not leaves or self.config.backend == "xla":
            return RecompileReport()
        m = mesh if mesh is not None else current()
        avals = tuple(TensorSpec(m.local_shape(l), l.dtype) for l in leaves)
        sizes = dict(axis_sizes or {})
        shape_preserving = bool(getattr(delta, "shape_preserving", True))
        if not shape_preserving:
            sizes.update(dict(getattr(delta, "axis_sizes", None) or {}))
        with _obs.recording() as rec:
            with m:
                compiled = self._sync_program(
                    treedef, avals, n_total, axis_sizes=sizes or None,
                    masked=masked)
            arenas = self.init_arenas(
                grads_like, mesh=m, n_total=n_total,
                axis_sizes=sizes or None, masked=masked)
        prog_rebuilt = int(rec.counter("compile.cache_miss") > 0)
        arena_rebuilt = 0 if arenas is None else int(
            rec.counter("arena.alloc") > 0)
        report = RecompileReport(
            programs_reused=1 - prog_rebuilt,
            programs_rebuilt=prog_rebuilt,
            arenas_reused=0 if arenas is None else 1 - arena_rebuilt,
            arenas_rebuilt=arena_rebuilt,
            shape_preserving=shape_preserving)
        _obs.RECORDER.count("recompile.programs_reused",
                            report.programs_reused)
        _obs.RECORDER.count("recompile.programs_rebuilt",
                            report.programs_rebuilt)
        _obs.RECORDER.count("recompile.arenas_reused",
                            report.arenas_reused)
        _obs.RECORDER.count("recompile.arenas_rebuilt",
                            report.arenas_rebuilt)
        _obs.RECORDER.event("engine.recompile",
                            shape_preserving=shape_preserving,
                            full=report.full_recompile)
        self._last_sync = compiled
        return report

    def _sync_program(self, treedef, avals: tuple,
                      n_total: Optional[int] = None, *,
                      axis_sizes: Optional[dict] = None,
                      masked: bool = False):
        """Build (or fetch) the compiled gradient-sync switch program for
        one pytree structure; axis sizes come from ``axis_sizes``, then
        the active mesh.  Under ``autotune`` the effective config comes
        from the tuning DB (searched and stored on a miss)."""
        cfg = self.config
        sizes = live_axis_sizes(self._axes(), axis_sizes)
        # the sizes are part of the key: the same engine may serve meshes
        # of different DP size, and the schedule choice depends on them.
        # The config's cache_key is too — the autotuner hands back
        # configs differing only in tuned fields, and those must compile
        # to distinct programs, not collide with the default's entry.
        key0 = (treedef, avals, n_total, tuple(sorted(sizes.items())),
                masked)
        cfg_eff = cfg
        if cfg.autotune and sizes.get(self.inner_axis):
            cfg_eff = self._tune_cache.get(key0)
            if cfg_eff is None:
                cfg_eff = self._tuned_sync_config(avals, n_total, sizes)
                self._tune_cache[key0] = cfg_eff
        key = key0 + (cfg_eff.cache_key(),)
        hit = self._sync_cache.get(key)
        if hit is not None:
            _obs.RECORDER.count("compile.cache_hit")
            self._last_sync = hit
            return hit
        _obs.RECORDER.count("compile.cache_miss")
        compiled = self._build_sync(cfg_eff, avals, n_total, sizes,
                                    masked=masked)
        self._sync_cache[key] = compiled
        self._last_sync = compiled
        return compiled

    def _tuned_sync_config(self, avals, n_total, sizes):
        """Resolve the effective config through the tuning DB: a stored
        winner for this (pytree structure, topology) applies directly; a
        miss searches the tunable space offline (analytic replay over
        recompiled candidates) and persists the winner."""
        from repro_torch import tune

        cfg = self.config
        topo = self.topology(axis_size=sizes)
        in_avals = avals + (avals if self.compressed else ())
        tkey = tune.plan_key(
            f"gradient_sync[{cfg.backend}x{len(avals)}]",
            in_avals, topo, cfg)
        return tune.tuned_config(
            cfg,
            lambda c: self._build_sync(c, avals, n_total, sizes),
            key=tkey, db_path=cfg.tune_db)

    def _build_sync(self, cfg, avals, n_total, sizes, *,
                    masked: bool = False):
        """Trace + compile the gradient-sync program under ``cfg`` (also
        the candidate compile the autotune search runs).

        On ``acis_compressed`` each leaf runs the error-feedback triple
        around one ``ef_reduce``: the target ``g + r`` in the gradient's
        dtype, the mean of the lossy total, and the new residual
        ``t - delivered`` in the residual's dtype (the reference's
        dtype rules).

        ``masked=True`` builds the bounded-staleness variant: one extra
        input (each rank's alive flag, rank-stacked), per-leaf
        ``masked_reduce`` with renormalization — the live count travels
        in the payload's flat bucket, so the program has the ring
        structure of the unmasked one.  On the compressed backends the
        masked target feeds the usual EF triple and one exact scalar
        reduce carries the live count."""
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

        def _masked_ef_target(g, r, a):
            t = g + r.to(g.dtype)
            live = ambient().rank_bcast(a != 0, t)
            return torch.where(live, t, torch.zeros_like(t))

        def _ef_residual(t, delivered, r):
            return (t.to(torch.float32) - delivered).to(r.dtype)

        def _masked_mean(y, c):
            return y / ambient().rank_bcast(torch.clamp_min(c, 1)
                                            .to(y.dtype), y)

        def sync(*args):
            if masked:
                alive = args[-1]
                args = args[:-1]
            gs, rs = args[:n_leaves], args[n_leaves:]
            outs, news = [], []
            cnt = None
            if masked and compressed:
                # the EF wire is lossy; the divisor must not be — one
                # exact scalar ring carries the live count for all leaves
                cnt = tracing.reduce(alive, ADD, axis="auto")
            for i, g in enumerate(gs):
                if compressed:
                    if masked:
                        t = tracing.map(_masked_ef_target, g, rs[i], alive,
                                        name="masked_ef_target")
                    else:
                        t = tracing.map(_ef_target, g, rs[i],
                                        name="ef_target")
                    red, dlv = tracing.ef_reduce(
                        t, compressor=cfg.compressor,
                        topk_ratio=cfg.topk_ratio, axis="auto")
                    if masked:
                        outs.append(tracing.map(_masked_mean, red, cnt,
                                                name="masked_mean"))
                    else:
                        outs.append(tracing.map(_mean, red, name="mean",
                                                elementwise=True))
                    news.append(tracing.map(_ef_residual, t, dlv, rs[i],
                                            name="ef_residual"))
                elif masked:
                    red, _ = tracing.masked_reduce(g, alive, ADD,
                                                   axis="auto")
                    outs.append(red)
                else:
                    red = tracing.reduce(g, ADD, axis="auto")
                    outs.append(tracing.map(_mean, red, name="mean",
                                            elementwise=True))
            return tuple(outs) + tuple(news)

        tag = "masked," if masked else ""
        prog = tracing.trace(
            sync, name=f"gradient_sync[{tag}{cfg.backend}x{n_leaves}]",
            num_inputs=n_leaves * (2 if compressed else 1) + int(masked))
        # the residual inputs are sized by the gradient avals, as in the
        # reference (its in_avals are avals + avals); the alive flag is a
        # per-rank f32 scalar
        in_avals = avals + (avals if compressed else ()) \
            + ((TensorSpec((), torch.float32),) if masked else ())
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
        cfg = self.config
        if cfg.autotune and in_avals is not None:
            # candidates are scored on rank-local plans (analytic replay);
            # the winning config then drives the real compile, on a mesh
            # or not
            from repro_torch import tune
            from repro_torch.core import program as _program

            name = getattr(prog, "name", None) \
                or getattr(prog, "__name__", "program")
            if not isinstance(prog, (_program.DagProgram,
                                     _program.SwitchProgram)):
                # trace once, not once per search candidate — and in_avals
                # fixes the arity for *args-signature programs, which
                # trace() alone cannot infer
                prog = tracing.trace(prog, num_inputs=len(in_avals))
            cfg = tune.tuned_config(
                cfg,
                lambda c: compiler.compile_rank_local(
                    prog, ax, axis_size=axis_size, config=c,
                    in_avals=in_avals, topology=topo),
                key=tune.plan_key(name, in_avals, topo, cfg),
                db_path=cfg.tune_db)
        if mesh is None:
            return compiler.compile_rank_local(
                prog, ax, axis_size=axis_size, config=cfg,
                in_avals=in_avals, topology=topo)
        if in_specs is None or out_specs is None:
            raise ValueError("mesh compilation needs in_specs and out_specs")
        return compiler.compile_program(
            prog, mesh, ax, in_specs, out_specs, config=cfg,
            in_avals=in_avals, topology=topo)


def make_engine(backend: str = "xla", *, inner_axis: str = "data",
                outer_axis: Optional[str] = None, **kw) -> CollectiveEngine:
    return CollectiveEngine(CollectiveConfig(backend=backend, **kw),
                            inner_axis=inner_axis, outer_axis=outer_axis)
