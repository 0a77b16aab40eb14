"""Parameter / activation sharding rules (DP × FSDP × TP × EP).

The port of :mod:`repro.sharding.rules`.  Logical scheme on the
production mesh ("pod", "data", "model"):

  * batch           → ("pod", "data")              (DP)
  * weight in-dims  → "data"                       (FSDP / ZeRO)
  * weight out-dims → "model"                      (TP, Megatron col/row)
  * vocab           → "model"                      (vocab-parallel embed+head)
  * experts         → "model" when divisible (EP), else expert-internal TP
  * scan dim (L)    → unsharded

Rules match on parameter *path* (joined with '/') and param rank; paths
under "layers/" carry a leading stacked dim that gets a None prepended.
Anything unmatched is replicated — norms, gates, biases, small vectors.

A mesh is anything with ``axis_names`` and ``shape`` (``{axis: size}``):
a :class:`~repro_torch.mesh.LocalMesh`, on any device (``meta`` for the
production meshes of the dry run).  Specs are the port's
:class:`~repro_torch.mesh.PartitionSpec`.  A layout is applied with
``LocalMesh.shard`` / ``unshard`` (:func:`shard_tree`,
:func:`unshard_tree`): every rank holds its shard, the ranks of the axes
a spec leaves out hold copies.
"""

from __future__ import annotations

import re
from typing import Any, Optional

import torch

from repro_torch import tree
from repro_torch.mesh import PartitionSpec as P

PyTree = Any

FSDP = "data"
TP = "model"


def dp_axes(mesh, parallelism: str = "fsdp_tp") -> tuple[str, ...]:
    axes = ("pod", "data", "model") if parallelism == "pure_dp" else \
        ("pod", "data")
    return tuple(a for a in axes if a in mesh.axis_names)


def _div(n: int, mesh, axis: str) -> bool:
    return axis in mesh.axis_names and n % mesh.shape[axis] == 0


def _ax(dim: int, mesh, axis: str) -> Optional[str]:
    return axis if _div(dim, mesh, axis) else None


# (regex, builder(shape, mesh) -> PartitionSpec)  — first match wins.
def _rules():
    return [
        # embedding table: FEATURE-sharded (P(None, model)), not vocab-
        # sharded (the reference's choice: its partitioner gathers a
        # feature-sharded table trivially)
        (r"embed$", lambda s, m: P(None, _ax(s[1], m, TP))),
        (r"lm_head$", lambda s, m: P(_ax(s[0], m, FSDP), _ax(s[1], m, TP))),
        (r"(dec_pos|enc/pos)$", lambda s, m: P(None, _ax(s[1], m, FSDP))),
        # MoE stacked experts [E, d_in, d_out]
        (r"experts/(wi_gate|wi_up|wi)$", _expert_spec_in),
        (r"experts/wo$", _expert_spec_out),
        (r"router$", lambda s, m: P(_ax(s[0], m, FSDP), None)),
        # rwkv channel-mix wv is an OUTPUT projection [F, D] (row-parallel),
        # unlike attention wv — it must precede the generic wv rule
        (r"ch/wv$", lambda s, m: P(_ax(s[0], m, TP), _ax(s[1], m, FSDP))),
        # attention / mla / ffn projections (col-parallel in, row-parallel out)
        (r"(wq|wk|wv|wi_gate|wi_up|wi|wx|wg|w_dq|w_uq|w_uk|w_uv|w_dkv"
         r"|wr|w_lora_a)$",
         lambda s, m: P(_ax(s[0], m, FSDP), _ax(s[1], m, TP))),
        (r"(wo|wout|w_lora_b)$",
         lambda s, m: P(_ax(s[0], m, TP), _ax(s[1], m, FSDP))),
        # conv kernels [width, C]
        (r"conv/kernel$", lambda s, m: P(None, _ax(s[1], m, TP))),
    ]


# Expert banks smaller than this replicate entirely when EP is not
# divisible: FSDP-sharding their contraction dim costs an activation-sized
# all-reduce per expert matmul, which dwarfs the memory saved on a ~1 GB
# bank (the reference's threshold, kept so the layouts agree).
_EXPERT_REPLICATE_BYTES = 2 << 30


def _expert_bank_bytes(s) -> int:
    n = 1
    for d in s:
        n *= d
    return 2 * n  # bf16


def _expert_spec_in(s, m):
    # [E, D, F]: EP over model when divisible, else TP inside the expert,
    # else (small bank) fully replicated.
    if _div(s[0], m, TP):
        return P(TP, _ax(s[1], m, FSDP), None)
    if _expert_bank_bytes(s) <= _EXPERT_REPLICATE_BYTES:
        return P(None, None, None)
    return P(None, _ax(s[1], m, FSDP), _ax(s[2], m, TP))


def _expert_spec_out(s, m):
    if _div(s[0], m, TP):
        return P(TP, None, _ax(s[2], m, FSDP))
    if _expert_bank_bytes(s) <= _EXPERT_REPLICATE_BYTES:
        return P(None, None, None)
    return P(None, _ax(s[1], m, TP), _ax(s[2], m, FSDP))


def spec_for_path(path: str, shape: tuple[int, ...], mesh,
                  *, stacked: bool) -> P:
    body_shape = shape[1:] if stacked else shape
    for pat, builder in _rules():
        if re.search(pat, path):
            spec = builder(body_shape, mesh)
            if stacked:
                spec = P(None, *spec)
            # rank guard: pad/truncate to param rank
            return P(*(tuple(spec) + (None,) * (len(shape) - len(spec)))
                     [:len(shape)])
    return P()  # replicated


def _path_str(path) -> str:
    """A path of dict keys / sequence indices joined with '/'."""
    return "/".join(str(k) for k in path)


def _is_stacked(path_str: str) -> bool:
    return path_str.startswith("layers/") or "/layers/" in path_str


def leaves_with_paths(t: PyTree, prefix: tuple = ()) -> list:
    """``[(path, leaf)]`` in flatten order; ``path`` is the tuple of dict
    keys and sequence indices down to the leaf.  A spec
    (:class:`PartitionSpec`) is a leaf."""
    if isinstance(t, P):
        return [(prefix, t)]
    if isinstance(t, dict):
        return [x for k in sorted(t)
                for x in leaves_with_paths(t[k], prefix + (k,))]
    if isinstance(t, (list, tuple)):
        return [x for i, v in enumerate(t)
                for x in leaves_with_paths(v, prefix + (i,))]
    if t is None:
        return []
    return [(prefix, t)]


def map_with_path(fn, t: PyTree) -> PyTree:
    """``tree_map`` whose ``fn(path, leaf)`` also sees the leaf's path
    (``t`` holds no specs: the generic flatten would open them)."""
    pairs = leaves_with_paths(t)
    _, td = tree.tree_flatten(t)
    return tree.tree_unflatten(td, [fn(p, x) for p, x in pairs])


def param_specs(param_shapes: PyTree, mesh,
                parallelism: str = "fsdp_tp") -> PyTree:
    """PartitionSpec pytree for a param (or optimizer-state) shape tree:
    any tree of leaves with a ``shape`` (``meta`` tensors serve)."""
    def one(path, leaf):
        ps = _path_str(path)
        spec = spec_for_path(ps, tuple(leaf.shape), mesh,
                             stacked=_is_stacked(ps))
        if parallelism == "pure_dp":
            # strip TP: params replicated over 'model', FSDP over 'data'
            spec = P(*(None if a == TP else a for a in tuple(spec)))
        return spec

    return map_with_path(one, param_shapes)


def param_shardings(param_shapes: PyTree, mesh,
                    parallelism: str = "fsdp_tp") -> PyTree:
    """The layout :func:`shard_tree` applies: one spec a leaf (the
    counterpart of the reference's ``NamedSharding`` tree)."""
    return param_specs(param_shapes, mesh, parallelism)


def spec_leaves(specs: PyTree) -> list:
    """The specs of a spec tree in flatten order (a spec is a tuple, so
    the generic flatten would open it)."""
    return [s for _, s in leaves_with_paths(specs)]


def shard_tree(t: PyTree, specs: PyTree, mesh) -> PyTree:
    """Every global leaf of ``t`` → its rank-stacked shard
    ``[*rank, *local]`` under its spec (``mesh.shard``)."""
    leaves, td = tree.tree_flatten(t)
    return tree.tree_unflatten(td, [mesh.shard(x, s) for x, s in zip(
        leaves, spec_leaves(specs))])


def unshard_tree(t: PyTree, specs: PyTree, mesh) -> PyTree:
    """The inverse of :func:`shard_tree` (``mesh.unshard``)."""
    leaves, td = tree.tree_flatten(t)
    return tree.tree_unflatten(td, [mesh.unshard(x, s) for x, s in zip(
        leaves, spec_leaves(specs))])


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def batch_spec(mesh, extra_dims: int = 1,
               parallelism: str = "fsdp_tp") -> P:
    """[B, ...] activations: batch over the DP axes."""
    return P(dp_axes(mesh, parallelism), *([None] * extra_dims))


def logits_spec(mesh) -> P:
    """[B, T, V]: batch over DP, vocab over TP (vocab-parallel CE)."""
    return P(dp_axes(mesh), None, TP)


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape one rank holds of a global ``shape`` under ``spec``."""
    out = list(shape)
    for j, e in enumerate(tuple(spec)[:len(out)]):
        axes = () if e is None else (e,) if isinstance(e, str) else tuple(e)
        for a in axes:
            out[j] //= mesh.shape[a]
    return tuple(out)


def constrain(x: torch.Tensor, mesh, spec: P,
              global_shape: Optional[tuple] = None) -> torch.Tensor:
    """The reference pins a layout here.  A rank-stacked tensor already
    carries its layout, so eager code has nothing to move: this checks
    that ``x`` holds the mesh's rank dims in front and, given the
    ``global_shape``, that its local shape is the one ``spec`` gives,
    and returns ``x`` as it is."""
    nd = len(mesh.axis_names)
    ranks = tuple(mesh.shape[a] for a in mesh.axis_names)
    if tuple(x.shape[:nd]) != ranks:
        raise ValueError(f"constrain: {tuple(x.shape)} does not carry the "
                         f"rank dims {ranks}")
    local = tuple(x.shape[nd:])
    if global_shape is not None and \
            local != local_shape(global_shape, spec, mesh):
        raise ValueError(f"constrain: local shape {local} is not "
                         f"{tuple(global_shape)} under {spec!r}")
    return x
