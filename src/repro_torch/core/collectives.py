"""ACiS Type 1 & 2 collectives — rank-local API with backend selection.

The PyTorch counterpart of :mod:`repro.core.collectives`.  Two backends:

  * ``"xla"``  — the *non-ACiS baseline*: one native reduction over the
    axis's rank dim (``sum``/``amax``/``amin``) broadcast back to every
    rank.  The network is a passive conduit and the op set is the fixed
    Type 1 one.  (The name is kept so configs mean the same thing in
    both packages.)
  * ``"acis"`` — the ring/log-step schedules of :mod:`repro_torch.core.
    ring` with per-hop compute: arbitrary monoids, wire codecs and
    hop-fused maps.

Everything here is rank-local (call inside ``with mesh:``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch import tree
from repro_torch.core import ring
from repro_torch.core.types import ADD, Monoid
from repro_torch.core.wire import IDENTITY, WireCodec
from repro_torch.mesh import current

PyTree = Any

_XLA_REDUCERS = {
    "add": lambda x, d: torch.sum(x, d, keepdim=True, dtype=x.dtype),
    "max": lambda x, d: torch.amax(x, d, keepdim=True),
    "min": lambda x, d: torch.amin(x, d, keepdim=True),
}


def _xla_reduce(name: str, x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``lax.psum``/``pmax``/``pmin``: reduce over the axis's rank dim and
    hand every rank the total."""
    d = current().dim(axis_name)
    return _XLA_REDUCERS[name](x, d).expand(x.shape).contiguous()


def _xla_gather(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``lax.all_gather(tiled=True)``: every rank gets the concat of all
    ranks' payloads along the local leading dim."""
    tp = current()
    d, nd = tp.dim(axis_name), tp.rank_ndim
    n = tp.axis_size(axis_name)
    y = x.movedim(d, nd - 1)        # the gathered rank dim sits last
    shp = tuple(y.shape)
    y = y.reshape(shp[:nd - 1] + (n * shp[nd],) + shp[nd + 1:])
    y = y.unsqueeze(nd - 1).movedim(nd - 1, d)
    return y.expand(tp.rank_shape + tuple(y.shape[nd:])).contiguous()


def all_reduce(
    x: torch.Tensor,
    axis_name: str,
    monoid: Monoid = ADD,
    *,
    backend: str = "acis",
    codec: WireCodec = IDENTITY,
    latency_optimal: bool = False,
    hop_combine: Optional[Callable] = None,
) -> torch.Tensor:
    """All-reduce ``x`` over ``axis_name`` with an arbitrary monoid & codec.

    Type 1 when ``monoid`` ∈ {add, max, min} and ``codec`` is identity;
    Type 2 otherwise.  The ``xla`` backend only supports the Type 1 subset
    and raises on anything more.
    """
    if backend == "xla":
        if monoid.name not in _XLA_REDUCERS:
            raise ValueError(
                f"xla backend supports only {sorted(_XLA_REDUCERS)} "
                f"(the Type 1 fixed-op limitation); got {monoid.name!r}. "
                "Use backend='acis' for user-defined (Type 2) ops.")
        if codec is not IDENTITY:
            raise ValueError("xla backend cannot apply wire codecs in-flight")
        return _xla_reduce(monoid.name, x, axis_name)

    if codec is IDENTITY:
        return ring.ring_all_reduce(x, axis_name, monoid,
                                    hop_combine=hop_combine,
                                    latency_optimal=latency_optimal)

    # Wire-coded path: encode once, combine in the encoded domain per hop
    # (the switch never sees the decoded stream), decode once at the end.
    if codec.combine_encoded is not None:
        enc = codec.encode(x)
        out = _tree_all_reduce_encoded(enc, axis_name, codec.combine_encoded)
        return codec.decode(out)
    # cast-style codec (bf16/fp8): encode before the hops, decode after
    enc = codec.encode(x)
    red = ring.ring_all_reduce(enc, axis_name, monoid,
                               hop_combine=hop_combine,
                               latency_optimal=latency_optimal)
    return codec.decode(red).to(x.dtype)


def _tree_all_reduce_encoded(enc: PyTree, axis_name: str,
                             combine: Callable[[PyTree, PyTree], PyTree]
                             ) -> PyTree:
    """RS∘AG ring all-reduce over an encoded pytree payload.

    Each chunk is folded along a chunk-determined rank walk, so every rank
    decodes the *identical* result after the all-gather even under a lossy
    combine.  Requires all leaves to share their local leading ("block")
    dimension.

    A combine that carries a ``fused_hop`` form (the int8 codec's under
    ``use_kernels``, :func:`repro_torch.core.wire.int8_codec`) runs each
    reduce-scatter hop on CUDA leaves as one ``fused_hop(buf, xs, s)``
    launch that reads the neighbour's ``buf`` and the local chunk in
    place, as :func:`repro_torch.core.ring.ring_reduce_scatter` does; CPU
    leaves take the shift + take + combine loop, which computes the same
    step.
    """
    tp = current()
    n = tp.axis_size(axis_name)
    if n == 1:
        return enc
    i = tp.axis_index(axis_name)
    d = tp.rank_ndim
    leading = {leaf.shape[d] for leaf in tree.tree_leaves(enc)}
    if len(leading) != 1:
        raise ValueError(f"encoded leaves must share leading dim, got {leading}")
    (nblocks,) = leading
    pad = (-nblocks) % n

    def pad_leaf(leaf):
        if not pad:
            return leaf
        fill = leaf.new_zeros(tuple(leaf.shape[:d]) + (pad,)
                              + tuple(leaf.shape[d + 1:]))
        return torch.cat([leaf, fill], dim=d)

    chunked = tree.tree_map(
        lambda l: ring._split_chunks(pad_leaf(l), n), enc)

    def chunk_at(idx):
        return tree.tree_map(lambda l: tp.take(l, idx), chunked)

    buf = chunk_at((i - 1) % n)
    fused = getattr(combine, "fused_hop", None)
    if fused is not None and all(leaf.is_cuda
                                 for leaf in tree.tree_leaves(chunked)):
        chunked = tree.tree_map(torch.Tensor.contiguous, chunked)
        for s in range(n - 1):
            buf = fused(buf, chunked, s, dim=tp.dim(axis_name), rank_ndim=d)
    else:
        for s in range(n - 1):
            incoming = ring.shift_tree(buf, axis_name, 1)
            buf = combine(incoming, chunk_at((i - 2 - s) % n))
    gathered = tree.tree_map(lambda l: ring.ring_all_gather(l, axis_name),
                             buf)
    return tree.tree_map(lambda l: l.narrow(d, 0, nblocks), gathered)


def reduce_scatter(
    x: torch.Tensor,
    axis_name: str,
    monoid: Monoid = ADD,
    *,
    backend: str = "acis",
    hop_combine: Optional[Callable] = None,
    codec: WireCodec = IDENTITY,
) -> torch.Tensor:
    if backend == "xla":
        if monoid.name != "add":
            raise ValueError("xla psum_scatter is add-only (Type 1 limitation)")
        if codec is not IDENTITY:
            raise ValueError("xla backend cannot apply wire codecs in-flight")
        tp = current()
        n = tp.axis_size(axis_name)
        total = _xla_reduce("add", x, axis_name)
        return tp.take(ring._split_chunks(total, n), tp.axis_index(axis_name))
    if codec is IDENTITY:
        return ring.ring_reduce_scatter(x, axis_name, monoid,
                                        hop_combine=hop_combine)
    if codec.combine_encoded is not None:
        # structured payloads (quantized pytrees) change the chunk layout;
        # only the full RS∘AG all-reduce schedule implements that walk
        raise ValueError(
            f"wire codec {codec.name!r} (encoded-domain combine) is not "
            "supported on a standalone reduce-scatter — use all_reduce, or "
            "drop the wire() declaration")
    # cast-style codec: hops and combines run in the wire dtype
    enc = codec.encode(x)
    red = ring.ring_reduce_scatter(enc, axis_name, monoid,
                                   hop_combine=hop_combine)
    return codec.decode(red).to(x.dtype)


def all_gather(
    x: torch.Tensor,
    axis_name: str,
    *,
    backend: str = "acis",
    hop_map: Optional[Callable] = None,
) -> torch.Tensor:
    if backend == "xla":
        if hop_map is not None:
            raise ValueError("xla backend cannot fuse maps into the gather")
        return _xla_gather(x, axis_name)
    return ring.ring_all_gather(x, axis_name, hop_map=hop_map)


def broadcast(x: torch.Tensor, axis_name: str, root: int = 0, *,
              backend: str = "acis", tree: bool = True) -> torch.Tensor:
    if backend == "xla":
        # no bcast primitive at this level: mask + psum (what a
        # fixed-function endpoint stack would do)
        tp = current()
        keep = tp.rank_bcast(tp.axis_index(axis_name) == root, x)
        return _xla_reduce(
            "add", torch.where(keep, x, torch.zeros_like(x)), axis_name)
    if tree:
        return ring.tree_broadcast(x, axis_name, root)
    return ring.ring_broadcast(x, axis_name, root)


def all_to_all(x: torch.Tensor, axis_name: str, *,
               backend: str = "acis") -> torch.Tensor:
    """[n*chunk, ...] -> [n*chunk, ...] with chunk j delivered to rank j."""
    if backend == "xla":
        tp = current()
        n = tp.axis_size(axis_name)
        xs = ring._split_chunks(x, n)
        # rank r's chunk j is rank j's chunk r: swap the axis's rank dim
        # with the chunk dim
        return xs.transpose(tp.dim(axis_name), tp.rank_ndim) \
            .contiguous().reshape(x.shape)
    return ring.ring_all_to_all(x, axis_name)


def prefix_scan(x: PyTree, axis_name: str, monoid: Monoid = ADD, *,
                exclusive: bool = False) -> PyTree:
    """Cross-rank prefix scan (Type 3 look-aside carry).  acis-only: there
    is no fixed-function scan collective — this op *only exists* because
    the network computes."""
    return ring.rank_prefix_scan(x, axis_name, monoid, exclusive=exclusive)
