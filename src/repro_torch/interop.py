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
inverses).  Dtypes are carried over (bfloat16 through a float32 round
trip, which is exact).
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
