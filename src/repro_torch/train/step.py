"""The acis train step: per-rank gradients → the switch gradient sync →
the optimizer.

The port of :func:`repro.train.step.build_train_step_acis` on a
:class:`~repro_torch.mesh.LocalMesh`, the paper's MPI-transparency point:
the model code is the same for every backend, only the gradient
transport changes.  The reference runs the step in a ``shard_map``
region manual over the DP axes; here every DP rank is a leading dim:

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

``build_train_step_gspmd`` (FSDP × TP under GSPMD) waits for ROADMAP.md
queue 1 item 9; until then the ``xla`` baseline is this step with
``make_engine("xla")``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import tree
from repro_torch.core.api import CollectiveEngine
from repro_torch.mesh import LocalMesh, PartitionSpec as P
from repro_torch.models.model import Model
from repro_torch.obs import metrics as _obs
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
        loss, m = _loss_fn(model, views, tok, ctx)
        g = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
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
    rank-stacked gradients).  ``grads`` are the ranks' own."""
    if state.sync_arenas is not None:
        synced, residual, arenas = engine.gradient_sync(
            grads, state.ef_residual, arenas=state.sync_arenas, mesh=mesh)
    else:
        synced, residual = engine.gradient_sync(grads, state.ef_residual,
                                                mesh=mesh)
        arenas = None
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
    gradient sync through ``engine`` (any backend; ``xla`` is the
    passive-network baseline).  ``batch["tokens"]`` is the global
    ``[B, T+1]`` batch, numpy or a tensor; an encdec or vlm model's
    ``batch["context"]`` (``[B, Tc, D]``) is split over the data ranks
    the way the tokens are.

    When the state carries ``sync_arenas`` (:func:`init_state` with
    ``arenas=True``) the bucket packs write into them in place and the
    same tensors come back in the new state.  ``recorder`` (a
    :class:`repro_torch.obs.metrics.Recorder`, by default the process
    recorder read at call time) counts ``train.steps`` and, when enabled,
    observes each step's wall seconds (``train.step_s``, after a device
    sync)."""

    def step_fn(state: TrainState, batch) -> tuple[TrainState, dict]:
        grads, metrics = local_grads(model, state, batch, mesh,
                                     microbatches=microbatches)
        new_state, metrics, _ = sync_and_update(engine, optimizer, state,
                                                grads, metrics, mesh)
        return new_state, metrics

    def timed(state, batch):
        rec = recorder if recorder is not None else _obs.RECORDER
        if not rec.enabled:
            return step_fn(state, batch)
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        rec.count("train.steps")
        rec.observe("train.step_s", time.perf_counter() - t0)
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
