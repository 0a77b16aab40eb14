"""GPipe-style pipeline parallelism over a "pipe" mesh axis.

The port of :mod:`repro.train.pipeline`.  Stage s holds layers
[s·L/S, (s+1)·L/S); microbatches stream through with handoffs between
neighbouring stages.  The schedule is the classic GPipe
fill-steady-drain loop over T = M + S - 1 ticks: at tick t, stage s
processes microbatch t - s (when 0 ≤ t - s < M).

On a :class:`~repro_torch.mesh.LocalMesh` every stage is a rank along
``pipe``: stage params are rank-stacked ``[S, ...]`` (the stage dim *is*
the rank dim) and one call of ``stage_fn`` runs every stage's tick at
once, as the reference's ``shard_map`` program runs on every device.
The handoff is ``shift`` by one along ``pipe`` (stage S-1 sends nothing,
stage 0 receives zeros, ``lax.ppermute`` with the open chain), and the
engine's Type 0 wire codec applies to the activation in transit
(encode, then decode at the receiver).  Forward only, as the reference's.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.core.wire import IDENTITY, WireCodec
from repro_torch.mesh import LocalMesh, PartitionSpec as P, current

PyTree = Any


def pipeline_forward(
    stage_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
    stage_params: PyTree,            # leaves [S, ...] (one stage a rank)
    x_microbatches: torch.Tensor,    # [S, M, mb, ...] (every rank's copy)
    axis_name: str = "pipe",
    codec: WireCodec = IDENTITY,
) -> torch.Tensor:
    """Rank-local (inside ``with mesh:``): ``stage_fn(params, x)`` maps
    every rank's ``[S, mb, ...]`` input through its own stage's params.
    Returns the final-stage outputs ``[S, M, mb, ...]``, valid on the
    last rank (the others hold zeros); callers broadcast them."""
    tp = current()
    s_count = tp.axis_size(axis_name)
    sid = tp.axis_index(axis_name)
    m = x_microbatches.shape[tp.rank_ndim]
    out = torch.zeros_like(x_microbatches)
    inflight = torch.zeros_like(tp.take(x_microbatches,
                                        torch.zeros_like(sid)))
    first, last = sid == 0, sid == s_count - 1
    for t in range(m + s_count - 1):
        mb_id = t - sid                           # which microbatch we see
        active = (mb_id >= 0) & (mb_id < m)
        idx = mb_id.clamp(0, m - 1)
        # stage 0 reads from the input stream; the others from the wire
        src = torch.where(tp.rank_bcast(first, inflight),
                          tp.take(x_microbatches, idx), inflight)
        y = stage_fn(stage_params, src)
        y = torch.where(tp.rank_bcast(active, y), y, torch.zeros_like(y))
        # the last stage writes its output slot; the others forward
        keep = tp.rank_bcast(last & active, y)
        tp.put(out, idx, torch.where(keep, y, tp.take(out, idx)))
        wire = y if codec is IDENTITY else codec.decode(codec.encode(y))
        moved = tp.shift(wire.to(y.dtype), axis_name, 1)
        inflight = torch.where(tp.rank_bcast(first, moved),
                               torch.zeros_like(moved), moved)
    return out


def run_pipeline(
    mesh: LocalMesh,
    stage_fn: Callable,
    stage_params: PyTree,            # [S, ...] stacked, global
    x: torch.Tensor,                 # [M, mb, ...]
    codec: WireCodec = IDENTITY,
) -> torch.Tensor:
    """Splits ``stage_params`` over ``pipe`` (``P("pipe")``: every leaf
    ``[S, 1, ...]``, each rank its ``[1, ...]`` slice, as the reference's
    in-specs give it), runs :func:`pipeline_forward` and broadcasts the
    final stage's result to every rank
    (:func:`repro_torch.core.ring.tree_broadcast`).  Returns the global
    ``[M, mb, ...]`` (rank 0's copy, the reference's ``out_specs=P()``)."""
    from repro_torch.core.ring import tree_broadcast

    s_count = mesh.axis_size("pipe")
    params = tree.tree_map(lambda p: mesh.shard(p, P("pipe")), stage_params)
    xs = mesh.shard(x, P())
    with torch.no_grad(), mesh:
        y = pipeline_forward(stage_fn, params, xs, "pipe", codec)
        y = tree_broadcast(y, "pipe", root=s_count - 1)
    return mesh.unshard(y, P())
