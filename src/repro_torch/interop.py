"""Hand the same data to the reference and to the port.

The reference shards a global array over mesh axes with a partition
spec: under ``P("data")`` rank ``r`` holds the ``r``-th slice of the
leading dim, under ``P("pod", "data", None)`` rank ``(p, d)`` holds
block ``[p, d]`` of the first two dims.  The port holds every rank's
slice in one tensor, ``[*rank, *local]``.
These functions convert between the two layouts (numpy on the
reference's side, torch on the port's), leaf by leaf for pytrees, so a
test can feed one seeded numpy input to both packages and compare.
Model params and serving caches have the same tree in both packages
(:func:`params_from_reference`, :func:`cache_from_reference` and their
inverses: every family's, an encdec model's ``enc`` and ``dec_pos``, MLA
leaves and the 0-dim cross gates of a vlm model included), and so has a
train state (:func:`train_state_from_reference`,
whose EF residual is read per device).  Dtypes are carried over
(bfloat16 through a float32 round trip, which is exact).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree
from repro_torch.mesh import LocalMesh, PartitionSpec

PyTree = Any


def _to_torch(x) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":        # ml_dtypes' bfloat16
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:          # a view of a JAX array
        arr = arr.copy()
    return torch.from_numpy(arr)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.to(torch.float32).numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def _spec(mesh: LocalMesh, spec):
    # the default: the leading dim over every mesh axis, the first axis
    # major (shard_map's split of a compound leading dim)
    return PartitionSpec(mesh.axis_names) if spec is None else spec


def ranks_from_reference(x_global, mesh: LocalMesh,
                         spec=None) -> torch.Tensor:
    """A global array the reference shards by ``spec`` → the port's
    rank-stacked tensor on the mesh's device.  ``spec`` defaults to the
    leading dim split over every mesh axis: ``[G, ...]`` →
    ``[*rank_shape, G / n_ranks, ...]``; ``P("pod", "data", None)`` takes
    ``[pod, data, L, ...]`` to ``[pod, data, 1, 1, L, ...]``."""
    return mesh.shard(_to_torch(x_global), _spec(mesh, spec))


def reference_from_ranks(x: torch.Tensor, mesh: LocalMesh,
                         spec=None) -> np.ndarray:
    """The inverse: the port's ``[*rank, *local]`` → the reference's
    global numpy array under ``spec`` (by default ``[n_ranks * L,
    ...]``, and ``[n_ranks]`` for one scalar a rank)."""
    if spec is None and x.dim() == mesh.rank_ndim:
        return _to_numpy(x.reshape(mesh.n_ranks))
    return _to_numpy(mesh.unshard(x, _spec(mesh, spec)))


def tree_ranks_from_reference(t: PyTree, mesh: LocalMesh) -> PyTree:
    return tree.tree_map(lambda x: ranks_from_reference(x, mesh), t)


def tree_reference_from_ranks(t: PyTree, mesh: LocalMesh) -> PyTree:
    return tree.tree_map(lambda x: reference_from_ranks(x, mesh), t)


def params_from_reference(t: PyTree, device="cpu") -> PyTree:
    """The reference's model params (a pytree of JAX or numpy arrays) →
    the port's, leaf by leaf on ``device``, dtypes kept."""
    return tree.tree_map(lambda x: _to_torch(x).to(device), t)


def params_to_reference(t: PyTree) -> PyTree:
    """The inverse: the port's params → numpy arrays, dtypes kept."""
    return tree.tree_map(_to_numpy, t)


# a serving cache is a pytree of arrays like the params
cache_from_reference = params_from_reference
cache_to_reference = params_to_reference


def _residual_from_reference(arr, mesh: LocalMesh) -> torch.Tensor:
    """One leaf of the reference's EF residual → ``[*rank, ...]``.

    The reference's acis step returns the residual with ``out_specs=P()``
    and ``check_vma=False``: the global array claims to be replicated,
    but each device keeps its own rank's residual.  So it is read per
    device (``addressable_shards``), each rank's copy taken from the
    first device at that rank's coordinates on the port mesh's axes.  An
    array made outside the step (the initial zeros, on one device) is one
    copy every rank holds."""
    jmesh = getattr(arr.sharding, "mesh", None)
    if jmesh is None:
        one = _to_torch(arr)
        return one.expand(mesh.rank_shape + tuple(one.shape)).contiguous() \
            .to(mesh.device)
    names = list(jmesh.axis_names)
    coords = {d.id: idx for idx, d in np.ndenumerate(np.asarray(jmesh.devices))}
    per: dict = {}
    for shard in sorted(arr.addressable_shards, key=lambda s: s.device.id):
        c = coords[shard.device.id]
        key = tuple(c[names.index(a)] for a in mesh.axis_names)
        per.setdefault(key, _to_torch(shard.data))
    return torch.stack([per[k] for k in np.ndindex(*mesh.rank_shape)]) \
        .reshape(mesh.rank_shape + tuple(arr.shape)).to(mesh.device)


def train_state_from_reference(state, mesh: LocalMesh, device=None, *,
                               specs=None):
    """The reference's ``TrainState`` → the port's, on ``device`` (the
    mesh's by default): params and optimizer state through
    :func:`params_from_reference`, the step as a 0-dim int32 tensor, the
    EF residual per device into ``[*rank, ...]``.  The sync arenas are
    scratch and are not carried over (allocate the port's with
    ``init_state(arenas=True)`` or ``engine.init_arenas``).

    A GSPMD state (global arrays) goes into the port's sharded layout
    with ``specs``, the port step's ``state_specs``: every param and
    optimizer leaf split over ``mesh`` (``LocalMesh.shard``)."""
    from repro_torch.sharding.rules import shard_tree
    from repro_torch.train.step import TrainState

    dev = mesh.device if device is None else torch.device(device)
    res = None if state.ef_residual is None else tree.tree_map(
        lambda x: _residual_from_reference(x, mesh).to(dev),
        state.ef_residual)
    params = params_from_reference(state.params, dev)
    opt = params_from_reference(state.opt, dev)
    if specs is not None:
        params = shard_tree(params, specs.params, mesh)
        opt = shard_tree(opt, specs.opt, mesh)
    return TrainState(params, opt,
                      torch.tensor(int(np.asarray(state.step)),
                                   dtype=torch.int32, device=dev), res)


def train_state_to_reference(state) -> dict:
    """The inverse, as numpy: ``{params, opt, step, ef_residual}`` (the
    residual keeps the port's ``[*rank, ...]``: the reference's global
    array holds one rank's copy, so it cannot take all of them)."""
    return {"params": params_to_reference(state.params),
            "opt": params_to_reference(state.opt),
            "step": _to_numpy(state.step),
            "ef_residual": None if state.ef_residual is None
            else params_to_reference(state.ef_residual)}
