"""Hand the same data to the reference and to the port.

The reference shards a global array over a mesh axis with
``P("data")``: rank ``r`` holds the ``r``-th slice of the leading dim.
The port holds every rank's slice in one tensor, ``[*rank, *local]``.
These functions convert between the two layouts (numpy on the
reference's side, torch on the port's), leaf by leaf for pytrees, so a
test can feed one seeded numpy input to both packages and compare.
Dtypes are carried over (bfloat16 through a float32 round trip, which is
exact).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree
from repro_torch.mesh import LocalMesh

PyTree = Any


def _to_torch(x) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":        # ml_dtypes' bfloat16
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.to(torch.float32).numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def ranks_from_reference(x_global, mesh: LocalMesh) -> torch.Tensor:
    """A global array the reference shards ``P(<every mesh axis>)`` over
    its leading dim → the port's rank-stacked tensor on the mesh's
    device: ``[G, ...]`` → ``[*rank_shape, G / n_ranks, ...]``."""
    t = _to_torch(x_global)
    n = mesh.n_ranks
    if t.shape[0] % n:
        raise ValueError(f"leading dim {t.shape[0]} not divisible by the "
                         f"{n} ranks of {mesh.axes}")
    return t.reshape(mesh.rank_shape + (t.shape[0] // n,)
                     + tuple(t.shape[1:])).to(mesh.device)


def reference_from_ranks(x: torch.Tensor, mesh: LocalMesh) -> np.ndarray:
    """The inverse: the port's ``[*rank, L, ...]`` → the reference's
    global ``[n_ranks * L, ...]`` numpy array."""
    nd = mesh.rank_ndim
    lead = x.shape[nd] if x.dim() > nd else 1
    return _to_numpy(x.reshape((mesh.n_ranks * lead,)
                               + tuple(x.shape[nd + 1:])))


def tree_ranks_from_reference(t: PyTree, mesh: LocalMesh) -> PyTree:
    return tree.tree_map(lambda x: ranks_from_reference(x, mesh), t)


def tree_reference_from_ranks(t: PyTree, mesh: LocalMesh) -> PyTree:
    return tree.tree_map(lambda x: reference_from_ranks(x, mesh), t)
