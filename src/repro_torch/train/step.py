"""Train-step builders, the port of :mod:`repro.train.step` on a
:class:`~repro_torch.mesh.LocalMesh`.  Two strategies:

  * ``gspmd`` (:func:`build_train_step_gspmd`, the ``xla`` backend): the
    passive-network baseline — params and optimizer state FSDP × TP
    sharded by :mod:`repro_torch.sharding.rules`, the partitioner's
    collectives written as native gathers, sums and slices over rank
    dims (:mod:`repro_torch.sharding.native`), one backward leaving
    every shard its gradient; also the program every dry-run cell runs
    on the meta device (:mod:`repro_torch.launch.cells`);
  * ``acis`` (:func:`build_train_step_acis`): per-rank gradients → the
    switch gradient sync → the optimizer, below.

The acis step is the paper's MPI-transparency point: the model code is
the same for every backend, only the gradient transport changes.  The
reference runs the step in a ``shard_map`` region manual over the DP
axes; here every DP rank is a leading dim:

  * tokens ``[B, T+1]`` are split over the mesh's axes (outer major) into
    ``[*rank, B / n, T+1]``, and an encdec or vlm batch's context ``[B,
    Tc, D]`` into ``[*rank, B / n, Tc, D]``;
  * **per-rank gradients in one forward and one backward**: the params
    enter the model as rank-expanded views (``p.expand(*rank, *p.shape)``,
    no copy), each rank's mean loss (plus its aux loss) is summed over
    the ranks, and ``torch.autograd.grad`` with respect to the views gives
    every rank its own gradient, ``[*rank, ...]`` — the layout
    ``gradient_sync`` takes;
  * microbatches accumulate in f32, as ``_accumulate_grads`` does;
  * ``engine.gradient_sync(grads, residual, arenas=...)`` mean-reduces
    them (the EF residual stays ``[*rank, ...]``);
  * after the all-gather every rank holds the same synced gradients (the
    reference's ``P()`` out-specs), so the optimizer runs once, on rank
    0's copy, over one copy of the params and the optimizer state;
  * the metrics are the mean over the ranks (the ``pmean``), and
    ``grad_norm`` is taken from the synced gradients.

With ``make_engine("xla")`` the acis step syncs replicated gradients
with the plain reduction; the FSDP × TP baseline is the gspmd step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch import tree
from repro_torch.core.api import CollectiveEngine
from repro_torch.mesh import LocalMesh, PartitionSpec as P
from repro_torch.models import parallel as TP
from repro_torch.models.model import Model
from repro_torch.obs import metrics as _obs
from repro_torch.obs import spans as _spans
from repro_torch.sharding import native, rules
from repro_torch.train.loss import cross_entropy
from repro_torch.train.optimizer import Optimizer

PyTree = Any


@dataclasses.dataclass
class TrainState:
    params: PyTree
    opt: PyTree
    step: torch.Tensor                     # 0-dim int32
    ef_residual: Optional[PyTree] = None   # Type 3 look-aside memory, [*rank, ...]
    # the gradient sync's persistent bucket arenas (engine.init_arenas):
    # threaded through the step, the packs write into them in place
    sync_arenas: Optional[tuple] = None


def _loss_fn(model: Model, params, tokens, context=None):
    """tokens: [..., b, T+1] — inputs tokens[..., :-1], targets
    tokens[..., 1:]; ``context`` [..., b, Tc, D] the encdec / vlm stub
    input.  Returns (loss + aux, metrics), one per rank."""
    hidden, aux = model.forward(params, tokens[..., :-1], context=context)
    logits = model.logits(params, hidden)
    loss, metrics = cross_entropy(logits, tokens[..., 1:])
    metrics["aux"] = aux.expand(loss.shape)
    return loss + aux, metrics


def rank_views(params: PyTree, rank_shape: tuple) -> PyTree:
    """Every param expanded over the rank dims (a view, no copy), as a
    leaf that autograd differentiates with respect to: the gradient of
    rank ``r``'s loss lands in slice ``r``."""
    return tree.tree_map(
        lambda p: p.detach().expand(tuple(rank_shape) + tuple(p.shape))
        .requires_grad_(), params)


def _accumulate_grads(model: Model, views: PyTree, tokens: torch.Tensor,
                      microbatches: int, context=None):
    """Per-rank gradients of each rank's mean loss over its microbatches,
    in f32 when ``microbatches > 1`` (the reference's ``lax.scan``
    accumulation: a running f32 sum, then ``* (1 / microbatches)``), and
    the per-rank metrics.  ``context`` splits into the microbatches with
    the tokens."""
    b = tokens.shape[-2]
    if b % microbatches:
        raise ValueError(f"a rank's batch of {b} does not split into "
                         f"{microbatches} microbatches")
    mb = b // microbatches
    leaves, td = tree.tree_flatten(views)

    def grads_of(tok, ctx):
        with _spans.span("train.forward"):
            loss, m = _loss_fn(model, views, tok, ctx)
            total = loss.sum()
        with _spans.span("train.backward"):
            g = torch.autograd.grad(total, leaves, allow_unused=True)
            g = [torch.zeros(p.shape, dtype=p.dtype, device=p.device)
                 if x is None else x for x, p in zip(g, leaves)]
        return g, {k: v.detach() for k, v in m.items()}

    with torch.enable_grad():
        if microbatches == 1:
            g, m = grads_of(tokens, context)
            return tree.tree_unflatten(td, g), m
        acc_g = acc_m = None
        for i in range(microbatches):
            rows = slice(i * mb, (i + 1) * mb)
            g, m = grads_of(tokens[..., rows, :], None if context is None
                            else context[..., rows, :, :])
            if acc_g is None:
                acc_g = [torch.zeros(x.shape, dtype=torch.float32,
                                     device=x.device) for x in g]
                acc_m = {k: torch.zeros_like(v) for k, v in m.items()}
            acc_g = [a + x.to(torch.float32) for a, x in zip(acc_g, g)]
            acc_m = {k: acc_m[k] + v for k, v in m.items()}
            del g
    inv = 1.0 / microbatches
    return (tree.tree_unflatten(td, [x * inv for x in acc_g]),
            {k: v * inv for k, v in acc_m.items()})


def dp_spec(mesh: LocalMesh) -> P:
    """The batch's spec: the leading dim over every mesh axis, the first
    axis major (the reference's ``P(dp)``)."""
    return P(tuple(mesh.axis_names))


def local_grads(model: Model, state: TrainState, batch: dict,
                mesh: LocalMesh, *, microbatches: int = 1):
    """Every rank's gradients ``[*rank, ...]`` and metrics ``[*rank]``
    for the global ``batch`` (numpy or tensors, ``tokens [B, T+1]`` and,
    for encdec / vlm, ``context [B, Tc, D]``, both split over the ranks
    by the batch dim)."""
    tokens = mesh.shard(torch.as_tensor(batch["tokens"]), dp_spec(mesh))
    context = batch.get("context")
    if context is not None:
        context = mesh.shard(torch.as_tensor(context), dp_spec(mesh))
    views = rank_views(state.params, mesh.rank_shape)
    return _accumulate_grads(model, views, tokens, microbatches, context)


def rank0(t: PyTree, nd: int) -> PyTree:
    """Rank 0's copy of every rank-stacked leaf."""
    return tree.tree_map(lambda g: g[(0,) * nd], t)


def sync_and_update(engine: CollectiveEngine, optimizer: Optimizer,
                    state: TrainState, grads: PyTree, metrics: dict,
                    mesh: LocalMesh):
    """The sync and the update: returns (new state, metrics, the synced
    rank-stacked gradients).  ``grads`` are the ranks' own.  They run
    under the spans ``train.sync`` and ``train.update``."""
    with _spans.span("train.sync"):
        if state.sync_arenas is not None:
            synced, residual, arenas = engine.gradient_sync(
                grads, state.ef_residual, arenas=state.sync_arenas,
                mesh=mesh)
        else:
            synced, residual = engine.gradient_sync(
                grads, state.ef_residual, mesh=mesh)
            arenas = None
    with _spans.span("train.update"):
        g0 = rank0(synced, mesh.rank_ndim)
        new_params, new_opt = optimizer.update(g0, state.opt, state.params,
                                               state.step)
        with torch.no_grad():
            out = {k: v.mean() for k, v in metrics.items()}
            gn = 0.0
            for g in tree.tree_leaves(g0):
                gn = gn + g.to(torch.float32).square().sum()
            out["grad_norm"] = torch.sqrt(torch.as_tensor(gn))
    return (TrainState(new_params, new_opt, state.step + 1, residual,
                       arenas), out, synced)


def build_train_step_acis(model: Model, optimizer: Optimizer,
                          mesh: LocalMesh, engine: CollectiveEngine, *,
                          microbatches: int = 1,
                          recorder=None) -> Callable:
    """(state, batch) -> (state, metrics) over ``mesh``'s ranks, the
    gradient sync through ``engine`` (any backend; ``xla`` syncs the
    replicated gradients with the plain reduction, and
    :func:`build_train_step_gspmd` is the FSDP × TP baseline).  ``batch["tokens"]`` is the global
    ``[B, T+1]`` batch, numpy or a tensor; an encdec or vlm model's
    ``batch["context"]`` (``[B, Tc, D]``) is split over the data ranks
    the way the tokens are.

    When the state carries ``sync_arenas`` (:func:`init_state` with
    ``arenas=True``) the bucket packs write into them in place and the
    same tensors come back in the new state.  ``recorder`` (a
    :class:`repro_torch.obs.metrics.Recorder`, by default the process
    recorder read at call time) counts ``train.steps``.  A step runs
    under the span ``train.step``; with the process recorder's span log
    on, its forward, backward, sync and update are spans of their own
    (:func:`repro_torch.obs.spans.span`), and nothing synchronises."""

    def step_fn(state: TrainState, batch) -> tuple[TrainState, dict]:
        grads, metrics = local_grads(model, state, batch, mesh,
                                     microbatches=microbatches)
        new_state, metrics, _ = sync_and_update(engine, optimizer, state,
                                                grads, metrics, mesh)
        return new_state, metrics

    def timed(state, batch):
        with _spans.span("train.step"):
            out = step_fn(state, batch)
        (recorder if recorder is not None else _obs.RECORDER).count(
            "train.steps")
        return out

    timed.mesh = mesh
    return timed


def grads_like(params: PyTree, mesh: LocalMesh, *,
               microbatches: int = 1) -> PyTree:
    """Stand-ins for the step's rank-stacked gradients (expanded views
    of one empty tensor a leaf, no memory): what ``engine.init_state``
    and ``engine.init_arenas`` read the shapes and dtypes of.
    Accumulated gradients are f32, one microbatch's carry the param
    dtype."""
    return tree.tree_map(
        lambda p: torch.empty(
            p.shape, device=p.device,
            dtype=torch.float32 if microbatches > 1 else p.dtype)
        .expand(mesh.rank_shape + tuple(p.shape)), params)


def init_state(model: Model, optimizer: Optimizer,
               generator: Optional[torch.Generator],
               engine: Optional[CollectiveEngine] = None, *,
               mesh: Optional[LocalMesh] = None, arenas: bool = False,
               microbatches: int = 1, device=None) -> TrainState:
    """Seeded params (``generator`` on the params' device: ``device``,
    else the mesh's, else the card), the optimizer state, step 0, and for
    an ``acis*`` engine its EF residual (``acis_compressed``: f32 zeros
    ``[*rank, ...]``; ``mesh`` required) and, with ``arenas=True``, the
    sync's bucket arenas.  Pass the step's ``microbatches``: it decides
    the gradient dtypes the arenas must match (accumulated gradients are
    f32, one microbatch's carry the param dtype)."""
    if device is None and mesh is not None:
        device = mesh.device
    params = model.init(generator, device=device)
    opt = optimizer.init(params)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree.tree_leaves(params)[0].device)
    residual = sync_arenas = None
    if engine is not None and engine.config.backend != "xla":
        if mesh is None:
            raise ValueError("init_state with an acis engine needs mesh=: "
                             "the EF residual and the arenas are "
                             "rank-stacked")
        like = grads_like(params, mesh, microbatches=microbatches)
        residual = engine.init_state(like)
        if arenas:
            sync_arenas = engine.init_arenas(like, mesh=mesh)
    return TrainState(params, opt, step, residual, sync_arenas)


# ---------------------------------------------------------------------------
# GSPMD strategy (xla backend / dry-run path): FSDP × TP on a LocalMesh
# ---------------------------------------------------------------------------

# block kinds whose attention / dense FFN consult the tensor-parallel hook
# after their row-parallel ``wo`` (transformer._block)
_ATTN_TP_KINDS = frozenset(("self", "window", "dense_self", "moe_self",
                            "enc_self"))
_FFN_TP_KINDS = frozenset(("self", "window", "dense_self", "enc_self"))
_COL = ("wq", "wk", "wv", "wi", "wi_gate", "wi_up")


def tp_plan(cfg, mesh) -> tuple[bool, bool]:
    """(attention split over ``model``, dense FFN split over ``model``).

    A block's attention is split (column ``wq/wk/wv``, row ``wo``) when
    every attention of the model reaches the hook's ``attn_reduce``
    (GQA, no MLA; no cross-attention block, which reads the same head
    counts unsplit) and the heads divide the axis; the dense FFNs of the
    kinds that call ``ffn_reduce`` when their hidden dims divide it.
    Everything else runs gathered whole on every rank, expert banks
    stored expert-parallel excepted (:func:`compute_spec`)."""
    from repro_torch.models.transformer import layer_schedule

    m = mesh.shape.get("model", 1)
    if m == 1 or cfg.parallelism == "pure_dp":
        return False, False
    kinds = set(layer_schedule(cfg))
    if cfg.family == "encdec":
        kinds.add("enc_self")
    attn_kinds = kinds - {"lru", "rwkv"}
    attn = (bool(attn_kinds) and cfg.mla is None
            and attn_kinds <= _ATTN_TP_KINDS
            and cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0)
    ffn_kinds = kinds & _FFN_TP_KINDS
    widths = [cfg.moe.d_ff_dense or cfg.d_ff if k == "dense_self"
              else cfg.d_ff for k in ffn_kinds]
    return attn, bool(widths) and all(w % m == 0 for w in widths)


def _block_kind(path) -> Optional[str]:
    for k in path:
        if isinstance(k, str) and k[:3] in ("pos", "rem") and "_" in k:
            return k.split("_", 1)[1]
    return None


def compute_spec(path, spec: P, attn_tp: bool, ffn_tp: bool) -> P:
    """The layout a leaf is used in: ``spec`` with every axis gathered
    except ``model`` on the split dim of a tensor-parallel projection
    (column: the last dim, row ``wo``: the one before) and on the expert
    dim of an expert bank stored expert-parallel (``[(L,) E, d_in,
    d_out]`` with E over ``model``: each rank computes its experts)."""
    kind, name = _block_kind(path), path[-1]
    owner = path[-2] if len(path) > 1 else None
    split = (attn_tp and owner == "attn" and kind in _ATTN_TP_KINDS) or \
        (ffn_tp and owner == "ffn" and kind in _FFN_TP_KINDS)
    entries = list(spec)
    keep = None
    if owner == "experts" and len(entries) >= 3 and \
            "model" in _axes_of(entries[len(entries) - 3]):
        keep = len(entries) - 3
    elif split and name in _COL:
        keep = len(entries) - 1
    elif split and name == "wo":
        keep = len(entries) - 2
    out = [None] * len(entries)
    if keep is not None:
        if "model" not in _axes_of(entries[keep]):
            raise ValueError(f"{'/'.join(map(str, path))}: split over "
                             f"model but stored as {spec!r}")
        out[keep] = "model"
    return P(*out)


def expert_parallel(pairs, cspecs) -> bool:
    """Whether the expert banks compute expert-parallel over ``model``
    (their compute layout keeps ``model`` on the expert dim)."""
    return any(len(path) > 1 and path[-2] == "experts"
               and "model" in {a for e in c for a in _axes_of(e)}
               for (path, _), c in zip(pairs, cspecs))


def _axes_of(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def to_layout(x: torch.Tensor, mesh, src: P, dst: P) -> torch.Tensor:
    """A rank-stacked leaf from layout ``src`` to ``dst`` (``dst``'s axes
    on a dim a subset of ``src``'s): the axes ``src`` replicates and
    ``dst`` too are marked replicated (their cotangents all-reduced),
    every other axis ``dst`` drops is all-gathered."""
    used_src = {a for e in src for a in _axes_of(e)}
    used_dst = {a for e in dst for a in _axes_of(e)}
    rep = [a for a in mesh.axis_names if a not in used_src | used_dst]
    x = native.replicate(x, mesh, rep)
    for j, e in enumerate(src):
        keep = _axes_of(dst[j]) if j < len(dst) else ()
        gather = [a for a in _axes_of(e) if a not in keep]
        if gather:
            x = native.all_gather(x, mesh, gather, j)
    return x


def reshard(x: torch.Tensor, mesh, src: P, dst: P) -> torch.Tensor:
    """A leaf from layout ``src`` to any ``dst``: the axes it leaves
    gathered, then each rank's slice of the axes it gains (no autograd)."""
    nd = x.dim() - mesh.rank_ndim
    src = tuple(src) + (None,) * (nd - len(tuple(src)))
    dst = tuple(dst) + (None,) * (nd - len(tuple(dst)))
    for j in range(nd):
        s, d = _axes_of(src[j]), _axes_of(dst[j])
        if s == d:
            continue
        x = native.all_gather(x, mesh, s, j)
        x = native.take_slice(x, mesh, d, j)
    return x


class ShardMeans:
    """Adafactor's means over a sharded leaf (param spec ``spec``): the
    local mean, then the mean over the ranks that split the param dim
    (an all-reduce), so the statistics equal the global ones."""

    def __init__(self, mesh, spec: P, ndim: int):
        self.mesh = mesh
        self.rank_ndim = mesh.rank_ndim
        self.entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))

    def mean(self, x, dim, pdim, keepdim=False):
        return native.all_mean(x.mean(dim, keepdim=keepdim), self.mesh,
                               _axes_of(self.entries[pdim]))

    def mean_all(self, x):
        local = x.mean(tuple(range(self.rank_ndim, x.dim())), keepdim=True)
        axes = [a for e in self.entries for a in _axes_of(e)]
        return native.all_mean(local, self.mesh, axes)


def layer_layouts(pairs, cspecs) -> dict:
    """``{path: (stored, compute)}`` of every stacked leaf, both layouts
    without the layer dim: what one period's view of it is gathered
    from and to."""
    return {path: (P(*tuple(s)[1:]), P(*tuple(c)[1:]))
            for (path, s), c in zip(pairs, cspecs)
            if rules._is_stacked(rules._path_str(path))}


class _GSPMDHook(TP.TensorParallel):
    """The forward's tensor-parallel hook: each period of the stacked
    layers gathered to its compute layout as the scan reaches it (FSDP
    per layer; its adjoint reduce-scatters that period's gradient), the
    row-parallel partials of split attention / FFN blocks summed over
    ``model`` (a native all-reduce, whose adjoint all-reduces the
    cotangents), and with expert-parallel banks (``ep``) each rank's
    experts fed their slots: the slot tensor, the same on every
    ``model`` rank, sliced to the rank's experts, their outputs
    all-gathered back (adjoint: a reduce-scatter).  The MoE load-balance
    loss takes its means over the global batch (an all-reduce over the
    DP axes), as the reference's global program does."""

    def __init__(self, mesh, attn: bool, ffn: bool, layers: dict,
                 ep: bool, dp: tuple):
        self.mesh, self.attn, self.ffn = mesh, attn, ffn
        self.layers, self.ep, self.dp = layers, ep, dp

    def moe_aux_means(self, me, ce):
        # the batch is split over the DP axes: the global batch's means
        return (native.all_mean(me, self.mesh, self.dp),
                native.all_mean(ce, self.mesh, self.dp))

    def moe_dispatch(self, xem):
        return native.take_slice(xem, self.mesh, ("model",), 0) \
            if self.ep else xem

    def moe_combine(self, yem, shared_partial=None):
        # the shared experts are not split: their output is whole
        if self.ep:
            yem = native.all_gather(yem, self.mesh, ("model",), 0)
        return yem, shared_partial

    def layer_params(self, pp, where):
        return rules.map_with_path(
            lambda path, x: to_layout(x, self.mesh,
                                      *self.layers[where + path]), pp)

    def attn_reduce(self, h):
        return native.all_reduce(h, self.mesh, ("model",)) if self.attn \
            else h

    def ffn_reduce(self, f):
        return native.all_reduce(f, self.mesh, ("model",)) if self.ffn \
            else f


def _key(k) -> str:
    return f"[{k}]" if isinstance(k, int) else f"['{k}']"


def _opt_specs(opt_shapes: PyTree, pspecs: PyTree) -> PyTree:
    """Optimizer-state sharding: match the param's spec when the shapes
    coincide (m/v), drop trailing axes for factored stats, scalars repl.
    (The reference's rule, first match in flatten order: a param whose
    path keys all appear in the state leaf's path.)"""
    flat_p = [(tuple(_key(k) for k in path), spec)
              for path, spec in rules.leaves_with_paths(pspecs)]

    def one(path, leaf):
        keys = tuple(_key(k) for k in path)
        for pk, spec in flat_p:
            if all(any(pp == kk for kk in keys) for pp in pk):
                if len(spec) == len(leaf.shape):
                    return spec
                # factored stats: take leading dims of the param spec
                return P(*tuple(spec)[:len(leaf.shape)])
        return P()

    return rules.map_with_path(one, opt_shapes)


def _split(batch, name: str, i: int, mb: int, microbatches: int):
    x = batch.get(name)
    if x is None:
        return None
    x = torch.as_tensor(x)
    return x if microbatches == 1 else x[i * mb:(i + 1) * mb]


def build_train_step_gspmd(model: Model, optimizer: Optimizer,
                           mesh: LocalMesh, *, microbatches: int = 1,
                           recorder=None) -> Callable:
    """(state, batch) -> (state, metrics) with FSDP × TP sharded params,
    the passive-network baseline (the reference's ``xla`` path).

    Params and optimizer state sit rank-stacked in the layout
    :func:`repro_torch.sharding.rules.param_specs` / :func:`_opt_specs`
    give on ``mesh`` (axes ``data`` and ``model``, and ``pod``); place a
    global state with ``fn.place_state`` and read one back with
    ``fn.unshard_state``.  ``batch["tokens"]`` is the global ``[B, T+1]``
    (numpy or a tensor), split by ``batch_spec`` (``context`` ``[B, Tc,
    D]`` likewise).  Per microbatch (the global batch split first, as the
    reference's scan splits it) one forward and one backward:

      * every leaf goes to its compute layout (:func:`to_layout`): FSDP
        all-gathers over ``data``, every leaf the hook does not split
        gathered whole over ``model`` too; only the split projections of
        :func:`tp_plan` and expert banks stored expert-parallel stay on
        ``model``.  The stacked layers' leaves
        are gathered one period at a time, as the scan reaches it (the
        hook's ``layer_params``); the embedding, head, final norm and
        the unstacked remainder blocks before the forward;
      * the forward runs under a tensor-parallel hook whose
        ``attn_reduce`` / ``ffn_reduce`` all-reduce over ``model``;
      * the loss is the mean over the ranks (the global batch's mean,
        plus aux); ``torch.autograd.grad`` runs the collectives' adjoints
        (reduce-scatters, all-reduces), leaving every shard its gradient;
        microbatches accumulate in f32, as ``_accumulate_grads`` does.

    Then the optimizer runs on the shards (AdamW elementwise; Adafactor
    with its row and column statistics averaged over the ranks that split
    them, :class:`ShardMeans`, its column statistic resharded from
    ``_opt_specs``' layout and back).  Metrics ``nll``, ``z_loss``,
    ``accuracy``, ``aux`` (means over the ranks) and ``grad_norm``.
    Collectives are native (:mod:`repro_torch.sharding.native`) and
    report to the active ``native.counting()`` log.  ``fn.grads(state,
    batch)`` and ``fn.update(state, grads, metrics)`` are the two halves
    (for profiling).  A step runs under the span ``train.step``
    (:func:`repro_torch.obs.spans.span`) and counts ``train.steps`` on
    ``recorder``, by default the process recorder."""
    from repro_torch.models.model import Model as _Model
    from repro_torch.sharding.act import activation_sharding

    cfg = model.cfg
    par = cfg.parallelism
    shapes = model.param_shapes()
    pspecs = rules.param_specs(shapes, mesh, par)
    opt_shapes = optimizer.init(shapes)
    ospecs = _opt_specs(opt_shapes, pspecs)
    state_specs = TrainState(pspecs, ospecs, P(), None)
    attn_tp, ffn_tp = tp_plan(cfg, mesh)
    pairs = rules.leaves_with_paths(pspecs)
    cspecs = [compute_spec(path, spec, attn_tp, ffn_tp)
              for path, spec in pairs]
    pflat = [spec for _, spec in pairs]
    local_model = model
    if attn_tp:
        m = mesh.shape["model"]
        local_model = _Model(dataclasses.replace(
            cfg, n_heads=cfg.n_heads // m, n_kv_heads=cfg.n_kv_heads // m,
            d_head=cfg.head_dim), use_kernels=model.use_kernels)
    layers = layer_layouts(pairs, cspecs)
    stacked = [path in layers for path, _ in pairs]
    ep = expert_parallel(pairs, cspecs)
    hook = _GSPMDHook(mesh, attn_tp, ffn_tp, layers, ep,
                      rules.dp_axes(mesh, par))
    batch_specs = {"tokens": rules.batch_spec(mesh, 1, par),
                   "context": rules.batch_spec(mesh, 2, par)}
    shape_leaves = tree.tree_leaves(shapes)
    copies = [math.prod(mesh.axis_size(a) for a in mesh.axis_names
                        if a not in {x for e in s for x in _axes_of(e)})
              for s in pflat]
    reducers = [ShardMeans(mesh, s, len(x.shape))
                for s, x in zip(pflat, shape_leaves)]
    # Adafactor's column statistic: stored in _opt_specs' layout (the
    # param spec's leading dims), computed in the gradient's (its last)
    vc_layouts = {}
    by_path = dict(pairs)
    opt_leaves = dict(rules.leaves_with_paths(opt_shapes))
    for (path, spec) in rules.leaves_with_paths(ospecs):
        if path[-1] == "vc":
            nd = len(opt_leaves[path].shape) + 1
            pspec = tuple(by_path[path[1:-1]])
            pspec = pspec + (None,) * (nd - len(pspec))
            natural = P(*pspec[:-2], pspec[-1])
            vc_layouts[path] = (spec, natural)

    def grads(state: TrainState, batch) -> tuple[PyTree, dict]:
        leaves, td = tree.tree_flatten(state.params)
        b = torch.as_tensor(batch["tokens"]).shape[0]
        if b % microbatches:
            raise ValueError(f"global batch {b} does not split into "
                             f"{microbatches} microbatches")
        mb = b // microbatches
        acc_g = acc_m = None
        for i in range(microbatches):
            tok = mesh.shard(_split(batch, "tokens", i, mb, microbatches),
                             batch_specs["tokens"])
            ctx = _split(batch, "context", i, mb, microbatches)
            if ctx is not None:
                ctx = mesh.shard(ctx, batch_specs["context"])
            views = [x.detach().requires_grad_() for x in leaves]
            with torch.enable_grad():
                # the stacked layers' leaves go in as stored: the hook
                # gathers one period at a time
                used = [v if st else to_layout(v, mesh, s, c)
                        for v, s, c, st in zip(views, pflat, cspecs,
                                               stacked)]
                with TP.tensor_parallel(hook):
                    loss, m = _loss_fn(local_model,
                                       tree.tree_unflatten(td, used),
                                       tok, ctx)
                g = torch.autograd.grad(loss.mean(), views,
                                        allow_unused=True)
            g = [torch.zeros_like(v) if x is None else x
                 for x, v in zip(g, views)]
            m = {k: v.detach().mean() for k, v in m.items()}
            if microbatches == 1:
                return tree.tree_unflatten(td, g), m
            if acc_g is None:
                acc_g = [torch.zeros(x.shape, dtype=torch.float32,
                                     device=x.device) for x in g]
                acc_m = {k: torch.zeros_like(v) for k, v in m.items()}
            acc_g = [a + x.to(torch.float32) for a, x in zip(acc_g, g)]
            acc_m = {k: acc_m[k] + v for k, v in m.items()}
            del g
        inv = 1.0 / microbatches
        return (tree.tree_unflatten(td, [x * inv for x in acc_g]),
                {k: v * inv for k, v in acc_m.items()})

    def _vc(opt, direction: int):
        if not vc_layouts:
            return opt
        def one(path, leaf):
            if path not in vc_layouts:
                return leaf
            src, dst = vc_layouts[path][::direction]
            return reshard(leaf, mesh, src, dst)
        return rules.map_with_path(one, opt)

    @torch.no_grad()
    def update(state: TrainState, g: PyTree, metrics: dict):
        opt = _vc(state.opt, 1)
        new_params, new_opt = optimizer.update(g, opt, state.params,
                                               state.step, reducers)
        sq = 0.0
        for x, n in zip(tree.tree_leaves(g), copies):
            sq = sq + x.to(torch.float32).square().sum() / n
        metrics = dict(metrics)
        metrics["grad_norm"] = torch.sqrt(torch.as_tensor(sq))
        return (TrainState(new_params, _vc(new_opt, -1), state.step + 1,
                           state.ef_residual), metrics)

    last: dict = {}

    def step_fn(state: TrainState, batch) -> tuple[TrainState, dict]:
        with activation_sharding(mesh, parallelism=par) as act:
            g, metrics = grads(state, batch)
        last["act"] = act
        return update(state, g, metrics)

    def timed(state, batch):
        with _spans.span("train.step"):
            out = step_fn(state, batch)
        (recorder if recorder is not None else _obs.RECORDER).count(
            "train.steps")
        return out

    def place_state(state: TrainState) -> TrainState:
        """A global state (every leaf whole) → its sharded layout."""
        return TrainState(rules.shard_tree(state.params, pspecs, mesh),
                          rules.shard_tree(state.opt, ospecs, mesh),
                          torch.as_tensor(state.step).to(mesh.device),
                          state.ef_residual)

    def unshard_state(state: TrainState) -> TrainState:
        return TrainState(rules.unshard_tree(state.params, pspecs, mesh),
                          rules.unshard_tree(state.opt, ospecs, mesh),
                          state.step, state.ef_residual)

    timed.mesh = mesh
    timed.state_specs = state_specs
    timed.batch_specs = batch_specs
    timed.place_state = place_state
    timed.unshard_state = unshard_state
    timed.grads = grads
    timed.update = update
    timed.tp_plan = (attn_tp, ffn_tp)
    timed.expert_parallel = ep
    timed.last = last             # "act": the last step's activation pins
    timed.compute_specs = cspecs
    return timed
