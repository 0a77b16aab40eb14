"""Compiled serving data path — decode/prefill collectives as switch programs.

The port of :mod:`repro.serve.collectives`.  Tensor-parallel serving
splits every layer's matmuls across a ``tp`` mesh axis, which turns the
decode hot loop into a *communication* loop: one all-reduce of attention
partials and one of FFN partials per layer, plus the MoE group->expert
all-to-all dispatch/combine.  This module expresses those as traced
:mod:`repro_torch.core` programs compiled through ``engine.compile`` —
the same pipeline (and the same ring schedules and hop kernels) the
gradient sync uses — and installs them into the models through the
:class:`repro_torch.models.parallel.TensorParallel` hook.

Three hook transports, selected by ``mode``:

  * ``xla``      — one plain reduction over the rank dim / an index swap
                   (the passive-network baseline; the name is the
                   reference's)
  * ``direct``   — per-op acis ring collectives, no compiler
  * ``compiled`` — switch programs from :meth:`ServeCollectives.program`:
                   sub-crossover payloads get the latency-optimal ring,
                   the MoE combine all-to-all fuses with the shared-expert
                   all-reduce into one Type-4 ``allreduce+alltoall``
                   stage, and ``use_kernels`` runs every ring hop's
                   combine as the ``fused_combine`` kernel on the card
                   (``fused_hop`` on a bandwidth ring, ``combine_kernel``
                   on a latency ring and on the fused stage's reduce).

All ranks of the ``tp`` mesh live on one device (:class:`~repro_torch.
mesh.LocalMesh`): a rank-local tensor carries the rank dim in front.  So
the port splits the trees once — :meth:`ServeCollectives.shard_params` /
:meth:`shard_cache` apply the reference's per-leaf partition specs
(:meth:`param_specs` / :meth:`cache_specs`) — and :meth:`decode_fn` takes
the split trees, where the reference's ``jit`` reshards full trees at
every dispatch.  A leaf whose spec is ``P()`` (norms, router, embedding,
``lm_head``) stays one tensor with no rank dim, shared by every rank.

Programs are cached in a process-wide :class:`SwitchProgramCache` shared
by every engine replica (``serve.program_cache_hit/miss`` counters).
:meth:`decode_comm_time` / :meth:`prefill_comm_time` are the cost
model's ``program_time`` of a tick's programs for the paper's switch,
never times on the card.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Optional

import torch

from repro_torch import tree
from repro_torch.core import collectives as C
from repro_torch.core import tracing
from repro_torch.core.api import CollectiveConfig, CollectiveEngine
from repro_torch.core.types import ADD, TensorSpec
from repro_torch.mesh import LocalMesh, PartitionSpec as P
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import parallel as TP
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import layer_schedule
from repro_torch.obs import metrics as _obs
from repro_torch.tune.search import plan_key

PyTree = Any


# ---------------------------------------------------------------------------
# the shared program cache
# ---------------------------------------------------------------------------

class SwitchProgramCache:
    """Process-wide compiled-program store shared across serving replicas.

    Keyed by :func:`repro_torch.tune.search.plan_key` of (program name,
    rank-local input avals, topology) plus the config's ``cache_key()`` —
    the tuning DB's identity, so two replicas of the same model at the
    same batch shape share every program, while a replica running a tuned
    or kernel-enabled config compiles its own.  Hits and misses land on
    the process recorder (``serve.program_cache_hit`` / ``_miss``).
    """

    def __init__(self):
        self._programs: dict = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get_or_build(self, key, build: Callable[[], Any]):
        with self._lock:
            hit = self._programs.get(key)
            if hit is not None:
                self.hits += 1
                _obs.RECORDER.count("serve.program_cache_hit")
                return hit
        # compile outside the lock (compiles can nest cache lookups via
        # autotune); last writer wins on a racing double-compile
        _obs.RECORDER.count("serve.program_cache_miss")
        prog = build()
        with self._lock:
            self._programs[key] = prog
            self.misses += 1
        return prog

    def __len__(self) -> int:
        return len(self._programs)

    def stats(self) -> dict:
        return {"programs": len(self._programs),
                "hits": self.hits, "misses": self.misses}

    def clear(self):
        with self._lock:
            self._programs.clear()
            self.hits = self.misses = 0


#: Default cache — every :class:`ServeCollectives` not handed an explicit
#: cache shares this one, so replicas in a process compile each program
#: once.
PROGRAM_CACHE = SwitchProgramCache()


# ---------------------------------------------------------------------------
# hook transports
# ---------------------------------------------------------------------------

class _TPBase(TP.TensorParallel):
    """Shared dispatch/combine plumbing; subclasses supply the transport.

    MoE resharding with replicated tokens (serving keeps activations
    replicated across tp; only weights are sliced):

      route: every rank routes on rank 0's copy of the tokens
        (:meth:`moe_route_input`), so every rank lays out the same slots
        and gathers its combine with the same indices.  The ranks' copies
        may differ by roundings (a latency-ring fold sums in each rank's
        own order, ROADMAP.md R4), and a router near a tie would
        otherwise send a token to other experts on one rank.
      dispatch: the all-to-all hands rank r the rows of *its* E/tp
        experts — chunk r of every peer's slot tensor [E, S, D] — and
        each rank keeps block 0 of its [tp, E/tp, ...] output (rank 0's
        tokens).
      combine: rank r tiles its local expert outputs [E/tp, S, D] tp
        times so every destination receives them; the all-to-all output
        is then the full [E, S, D] in expert order on every rank.

    Dispatch and combine are pure data movement.  Every tensor is
    rank-stacked ``[tp, ...]``.
    """

    # set by ServeCollectives' decode / prefill functions on a token
    # shape's first call (only the compiled hook reads it)
    tracing = False

    def __init__(self, axis: str, tp: int):
        self.axis = axis
        self.tp = tp

    # transport primitives -------------------------------------------------
    def _all_reduce(self, x):
        raise NotImplementedError

    def _all_to_all(self, x):
        raise NotImplementedError

    def _fused_combine(self, shared, tiled):
        """(all_reduce(shared), all_to_all(tiled)) — overridden where the
        pair can fuse into one switch stage."""
        return self._all_reduce(shared), self._all_to_all(tiled)

    # the model-facing hook ------------------------------------------------
    def attn_reduce(self, h):
        return self._all_reduce(h)

    def ffn_reduce(self, f):
        return self._all_reduce(f)

    def moe_route_input(self, xt):
        return xt[:1]

    def moe_dispatch(self, xem):
        el = xem.shape[-3] // self.tp
        out = self._all_to_all(xem)
        return out.reshape(out.shape[:-3] + (self.tp, el)
                           + out.shape[-2:])[..., 0, :, :, :]

    def moe_combine(self, yem, shared_partial=None):
        lead, local = yem.shape[:-3], yem.shape[-3:]
        tiled = yem.unsqueeze(-4).expand(lead + (self.tp,) + local) \
            .reshape(lead + (self.tp * local[0],) + local[1:])
        if shared_partial is None:
            return self._all_to_all(tiled), None
        reduced, full = self._fused_combine(shared_partial, tiled)
        return full, reduced


class XlaTPHook(_TPBase):
    """Passive-network baseline: one reduction over the rank dim."""

    def _all_reduce(self, x):
        return C.all_reduce(x, self.axis, ADD, backend="xla")

    def _all_to_all(self, x):
        return C.all_to_all(x, self.axis, backend="xla")


class DirectTPHook(_TPBase):
    """Per-op acis ring collectives — the uncompiled acis path.  Every
    call is its own bandwidth-optimal ring (2(n-1) hops); nothing is
    scheduled, fused, or batched, and no hop kernel runs."""

    def _all_reduce(self, x):
        return C.all_reduce(x, self.axis, ADD, backend="acis")

    def _all_to_all(self, x):
        return C.all_to_all(x, self.axis, backend="acis")


class CompiledTPHook(_TPBase):
    """Switch programs from the shared cache, built on first use per
    rank-local aval (decode and prefill shapes get distinct programs).

    The port consults the hook on every call, not once per trace, so it
    keeps the programs it has fetched in a dict keyed by (name, rank-local
    shapes and dtypes): a call pays one dict lookup.  While ``tracing``
    (the first call of a decode or prefill function at a token shape,
    where the reference's ``jit`` traces) every call looks its program
    up in the shared cache, as the reference's trace does, so the
    cache's hit and miss counts are the reference's."""

    def __init__(self, sc: "ServeCollectives"):
        super().__init__(sc.axis, sc.tp)
        self.sc = sc
        self._progs: dict = {}

    def _run(self, name, trace, *xs):
        key = (name,) + tuple((x.shape, x.dtype) for x in xs)
        prog = None if self.tracing else self._progs.get(key)
        if prog is None:
            avals = tuple(TensorSpec(tuple(x.shape[1:]), x.dtype)
                          for x in xs)
            prog = self._progs[key] = self.sc.program(name, trace, avals)
        return prog(*xs)

    def _all_reduce(self, x):
        return self._run("serve_tp_allreduce", self.sc._trace_allreduce,
                         x)[0]

    def _all_to_all(self, x):
        return self._run("serve_moe_alltoall", self.sc._trace_alltoall,
                         x)[0]

    def _fused_combine(self, shared, tiled):
        return tuple(self._run("serve_moe_combine", self.sc._trace_combine,
                               shared, tiled))


_MODES = ("compiled", "direct", "xla")


class Split(dict):
    """A param or cache tree already split over the ``tp`` mesh
    (:meth:`ServeCollectives.shard_params` / :meth:`~ServeCollectives.
    shard_cache` return one, and hand it back unchanged)."""


# ---------------------------------------------------------------------------
# ServeCollectives — sharding rules + program factory for one model config
# ---------------------------------------------------------------------------

class ServeCollectives:
    """Tensor-parallel serving plan for one :class:`ModelConfig`.

    Owns the ``tp`` mesh (a :class:`~repro_torch.mesh.LocalMesh` on
    ``device``, the card unless the caller passes ``device="cpu"``), the
    per-leaf parameter/cache :class:`~repro_torch.mesh.PartitionSpec`
    rules and the split they drive (:meth:`shard_params`,
    :meth:`shard_cache`), the rank-local decode and prefill wrappers
    (:meth:`decode_fn`, :meth:`prefill_fn`), and the switch-program
    factory backed by a shared :class:`SwitchProgramCache`.

    Supported families: ``dense`` and ``moe`` (GQA attention; MLA caches
    are latent-projected — slicing them is a different change).  ``tp``
    must divide ``n_heads``, ``n_kv_heads``, every FFN hidden dim, and
    (moe) ``n_experts``.
    """

    def __init__(self, cfg: ModelConfig, tp: int, *, axis: str = "tp",
                 config: Optional[CollectiveConfig] = None,
                 cache: Optional[SwitchProgramCache] = None,
                 device=None):
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"tensor-parallel serving supports dense/moe stacks, "
                f"not family={cfg.family!r}")
        if cfg.family == "moe" and cfg.mla is not None:
            raise NotImplementedError("MLA cache slicing not supported")

        def div(what, n):
            if n % tp:
                raise ValueError(f"tp={tp} must divide {what}={n}")
        div("n_heads", cfg.n_heads)
        div("n_kv_heads", cfg.n_kv_heads)
        div("d_ff", cfg.d_ff)
        if cfg.family == "moe":
            div("moe.n_experts", cfg.moe.n_experts)
            div("moe.d_ff_dense", cfg.moe.d_ff_dense or cfg.d_ff)
            if cfg.moe.n_shared:
                div("moe.d_ff_shared", cfg.moe.d_ff_shared
                    or cfg.moe.n_shared * cfg.moe.d_ff_expert)

        self.cfg = cfg
        self.tp = tp
        self.axis = axis
        self.config = config if config is not None \
            else CollectiveConfig(backend="acis")
        if self.config.backend == "xla":
            raise ValueError("compiled serving needs an acis backend; "
                             "use mode='xla' for the plain baseline")
        self.cache = cache if cache is not None else PROGRAM_CACHE
        self.engine = CollectiveEngine(self.config, inner_axis=axis)
        self.mesh = LocalMesh({axis: tp}, device=device)
        # rank-local view: each rank runs the same decode math over its
        # head/expert slice; head counts shrink, everything else (incl.
        # moe.n_experts — routing is replicated, expert compute reads the
        # sliced param shapes) stays the model's
        self.cfg_local = dataclasses.replace(
            cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
            d_head=cfg.head_dim)   # pin: head_dim derives from n_heads

    # -- traced program bodies ----------------------------------------------

    def _trace_allreduce(self, v):
        return tracing.reduce(v, ADD, axis=self.axis)

    def _trace_alltoall(self, v):
        return tracing.all_to_all(v, axis=self.axis)

    def _trace_combine(self, s, t):
        # independent same-axis REDUCE + ALLTOALL: FuseHops merges them
        # into one Type-4 allreduce+alltoall stage
        return (tracing.reduce(s, ADD, axis=self.axis),
                tracing.all_to_all(t, axis=self.axis))

    # -- program factory ----------------------------------------------------

    def program(self, name: str, fn, avals: tuple):
        """Compiled switch program for ``fn`` at the rank-local ``avals``
        (:class:`~repro_torch.core.types.TensorSpec`), from the shared
        cache.  The key is the tune-DB :func:`plan_key` identity plus the
        full config ``cache_key()`` (tuned/kernel variants must not
        collide)."""
        topo = self.engine.topology(axis_size={self.axis: self.tp})
        key = (plan_key(name, avals, topo, self.config),
               self.config.cache_key())
        return self.cache.get_or_build(
            key, lambda: self.engine.compile(
                tracing.trace(fn, num_inputs=len(avals), name=name),
                in_avals=avals, axis_size={self.axis: self.tp}))

    def hook(self, mode: str = "compiled") -> _TPBase:
        if mode == "compiled":
            return CompiledTPHook(self)
        if mode == "direct":
            return DirectTPHook(self.axis, self.tp)
        if mode == "xla":
            return XlaTPHook(self.axis, self.tp)
        raise ValueError(f"mode {mode!r} not in {_MODES}")

    # -- per-leaf sharding rules -------------------------------------------

    def _param_spec(self, keys: tuple, leaf) -> P:
        name = keys[-1] if keys else ""
        nd = leaf.dim()
        ax = self.axis
        if "experts" in keys:
            # stacked expert weights [..., E, d_in, d_out]: slice E
            return P(*(None,) * (nd - 3), ax, None, None)
        if name in ("wq", "wk", "wv", "wi", "wi_gate", "wi_up"):
            return P(*(None,) * (nd - 1), ax)      # column (head/ff) slice
        if name == "wo":
            return P(*(None,) * (nd - 2), ax, None)  # row slice -> partials
        return P()      # norms, router, embed, lm_head, gates: replicated

    def _cache_spec(self, keys: tuple, leaf) -> P:
        name = keys[-1] if keys else ""
        if name in ("k", "v"):
            # [..., B, S, Hkv, dh]: slice the kv-head dim
            return P(*(None,) * (leaf.dim() - 2), self.axis, None)
        raise ValueError(f"unsupported cache leaf {'/'.join(keys)}")

    @staticmethod
    def _map_with_path(fn, t: PyTree, keys: tuple = ()) -> PyTree:
        if isinstance(t, dict):
            return {k: ServeCollectives._map_with_path(fn, v, keys + (k,))
                    for k, v in t.items()}
        return fn(keys, t)

    def param_specs(self, params: PyTree) -> PyTree:
        return self._map_with_path(self._param_spec, params)

    def cache_specs(self, cache: PyTree) -> PyTree:
        return self._map_with_path(self._cache_spec, cache)

    # -- the split, once ------------------------------------------------------

    def _split(self, keys: tuple, leaf: torch.Tensor, spec: P
               ) -> torch.Tensor:
        """One leaf under ``spec``: unchanged when replicated, else the
        mesh's rank-stacked ``[tp, *local]`` — with the rank dim after the
        layer dim for a stacked ``layers`` leaf, so that per-layer views
        (``unbind(0)``) hand each layer its ``[tp, ...]`` slices."""
        if all(e is None for e in spec):
            return leaf
        out = self.mesh.shard(leaf, spec)
        if keys[:1] == ("layers",):
            out = out.movedim(0, 1).contiguous()
        return out

    def _unsplit(self, keys: tuple, leaf: torch.Tensor, spec: P
                 ) -> torch.Tensor:
        if all(e is None for e in spec):
            return leaf
        if keys[:1] == ("layers",):
            leaf = leaf.movedim(1, 0)
        return self.mesh.unshard(leaf, spec)

    def shard_params(self, params: PyTree) -> Split:
        """The full params → the rank-stacked tree :meth:`decode_fn`
        takes (one copy of every sliced leaf; replicated leaves are the
        same tensors).  A :class:`Split` tree comes back as it is."""
        if isinstance(params, Split):
            return params
        return Split(self._map_with_path(
            lambda k, x: self._split(k, x, self._param_spec(k, x)), params))

    def shard_cache(self, cache: PyTree) -> Split:
        if isinstance(cache, Split):
            return cache
        return Split(self._map_with_path(
            lambda k, x: self._split(k, x, self._cache_spec(k, x)), cache))

    def unshard_cache(self, cache: PyTree) -> PyTree:
        """The inverse of :meth:`shard_cache`: the full cache."""
        return self._map_with_path(
            lambda k, x: self._unsplit(k, x, self._cache_spec(
                k, x.select(1 if k[:1] == ("layers",) else 0, 0))), cache)

    # -- the decode and prefill programs ----------------------------------

    def _run_fn(self, step, hook: TP.TensorParallel):
        shapes: set = set()

        def run(params, tokens, *args, **kw):
            hook.tracing = tokens.shape not in shapes
            shapes.add(tokens.shape)
            try:
                with self.mesh, TP.tensor_parallel(hook), torch.no_grad():
                    return step(params, tokens, *args, **kw)
            finally:
                hook.tracing = False
        return run

    def decode_fn(self, params: PyTree = None, cache: PyTree = None, *,
                  mode: str = "compiled"):
        """``(params, token, cache, index) -> (logits, cache)`` over the
        split trees of :meth:`shard_params` / :meth:`shard_cache` — the
        same contract as ``Model.decode_step``, run rank-local on the
        mesh with the ``mode`` hook installed; the cache is updated in
        place.  Logits are rank 0's ``[B, V]`` (the ranks' copies are
        equal after the last all-reduce).  ``cache`` (split) fixes the
        batch whose programs are built eagerly in ``compiled`` mode;
        ``params`` is accepted for the reference's signature."""
        from repro_torch.models import decode as D

        del params
        hook = self.hook(mode)
        if mode == "compiled" and cache is not None:
            self.decode_programs(self._batch_of(cache))
        return self._run_fn(
            lambda p, tok, c, idx: D.decode_step(
                p, self.cfg_local, tok, c, idx, rank0=True), hook)

    def prefill_fn(self, *, mode: str = "compiled"):
        """``(params, tokens, cache) -> (logits, cache)``: ``Model.
        prefill`` over the split trees with the ``mode`` hook installed
        (a dense stack's batched pass runs :meth:`prefill_programs`, a
        MoE stack's T decode steps :meth:`decode_programs`)."""
        from repro_torch.models import decode as D

        return self._run_fn(
            lambda p, toks, c: D.prefill(p, self.cfg_local, toks, c,
                                         rank0=True), self.hook(mode))

    @staticmethod
    def _batch_of(cache: PyTree) -> int:
        """The batch of a split cache: dim 2 of a stacked ``[P, tp, B,
        S, H, dh]`` leaf, dim 1 of a remainder ``[tp, B, S, H, dh]``."""
        if cache["layers"]:
            return tree.tree_leaves(cache["layers"])[0].shape[2]
        return tree.tree_leaves(cache["rem"])[0].shape[1]

    # -- analytic costs (SLO admission, benchmarks) -------------------------

    def decode_programs(self, batch: int) -> list[tuple[str, Any, int]]:
        """The switch programs one decode tick runs, as ``(name,
        CompiledProgram, calls-per-tick)`` — built (or fetched) from the
        shared cache with the exact avals the hook will use."""
        return self._tick_programs(batch, 1)

    def prefill_programs(self, batch: int, t: int):
        """Programs of one *batched* prefill pass over a [batch, t]
        prompt (the ``model.prefill`` formulation of a dense stack —
        ``ServeEngine``'s in-batch prefill instead pays ``t`` decode
        ticks, and so does a MoE stack's prefill)."""
        return self._tick_programs(batch, t)

    def _tick_programs(self, b: int, t: int):
        cfg = self.cfg
        dt = L._dtype(cfg.param_dtype)     # the partials' dtype
        d = cfg.d_model
        counts: dict[str, list] = {}

        def add(name, fn, shapes):
            prog = self.program(name, fn, tuple(TensorSpec(s, dt)
                                                for s in shapes))
            ent = counts.setdefault(name, [prog, 0])
            ent[1] += 1

        n_tok = b * t
        g = MOE._n_groups(n_tok)
        ng = n_tok // g
        for kind in layer_schedule(cfg):
            add("serve_tp_allreduce", self._trace_allreduce,
                ((b, t, d),))                        # attention partials
            if kind != "moe_self":
                add("serve_tp_allreduce", self._trace_allreduce,
                    ((b, t, d),))                    # dense-FFN partials
                continue
            m = cfg.moe
            slot = (m.n_experts, g * MOE.capacity(m, n_tok, t), d)
            add("serve_moe_alltoall", self._trace_alltoall, (slot,))
            if m.n_shared:
                add("serve_moe_combine", self._trace_combine,
                    ((g, ng, d), slot))
            else:
                add("serve_moe_alltoall", self._trace_alltoall, (slot,))
        return [(name, prog, n) for name, (prog, n) in counts.items()]

    def decode_comm_time(self, batch: int) -> float:
        """The cost model's switch time (seconds) of one decode tick's
        communication — ``program_time`` over the tick's programs for the
        paper's switch, not a time on the card."""
        return sum(prog.program_time() * n
                   for _, prog, n in self.decode_programs(batch))

    def prefill_comm_time(self, batch: int, t: int) -> float:
        """The cost model's switch time (seconds) of one batched prefill
        pass, not a time on the card."""
        return sum(prog.program_time() * n
                   for _, prog, n in self.prefill_programs(batch, t))
