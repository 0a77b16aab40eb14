"""Ring / log-step collective schedules with per-hop compute.

The PyTorch counterpart of :mod:`repro.core.ring`.  A collective is a
sequence of hops over the active :class:`~repro_torch.mesh.Transport`,
and arbitrary compute (the paper's aggregation unit / CGRA program) is
attached to every hop.  Every function is rank-local: it runs inside
``with mesh:``, takes rank-stacked tensors ``[*rank, *local]`` and the
mesh ``axis_name`` it communicates over, and one hop moves and combines
the payload of every rank at once.

The hop walk, chunk indices and fold order are the reference's, so f32
add/max/min results are bitwise equal to it.  ``lax.scan`` over the hops
becomes a Python loop; ``lax.dynamic_index_in_dim`` with a rank-dependent
index becomes a per-rank gather (:meth:`Transport.take`).

Schedules: ``ring_reduce_scatter``, ``ring_all_gather``,
``ring_all_reduce`` (bandwidth RS∘AG or latency), ``ring_broadcast``,
``tree_broadcast``, ``rank_prefix_scan``, ``ring_all_to_all``.  Axis size
1 degenerates to identity for every schedule.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch import tree
from repro_torch.core.types import ADD, Monoid, TensorSpec
from repro_torch.mesh import ambient, current

PyTree = Any


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def shift_tree(x: PyTree, axis_name: str, k: int) -> PyTree:
    """Cyclic shift of every leaf: rank j sends to rank (j + k) % n."""
    tp = current()
    return tree.tree_map(lambda leaf: tp.shift(leaf, axis_name, k), x)


def _partial_shift(x: torch.Tensor, axis_name: str, k: int) -> torch.Tensor:
    """Non-cyclic shift used by log-step scans: ranks ``< k`` have no
    sender and receive zeros (what ``ppermute`` gives them)."""
    tp = current()
    got = tp.shift(x, axis_name, k)
    keep = tp.rank_bcast(tp.axis_index(axis_name) >= k, got)
    return torch.where(keep, got, torch.zeros_like(got))


def _split_chunks(x: torch.Tensor, n: int) -> torch.Tensor:
    """Reshape the local leading dim into [n, chunk, ...]."""
    d = ambient().rank_ndim
    if x.shape[d] % n:
        raise ValueError(
            f"leading dim {x.shape[d]} not divisible by axis size {n}")
    return x.reshape(tuple(x.shape[:d]) + (n, x.shape[d] // n)
                     + tuple(x.shape[d + 1:]))


def pad_to_multiple(x: torch.Tensor, n: int, fill=0, *,
                    monoid: Optional[Monoid] = None
                    ) -> tuple[torch.Tensor, int]:
    """Pad the local leading dim to a multiple of ``n``; returns (padded,
    original_len).

    ``monoid`` overrides ``fill`` with the monoid's identity element so the
    pad lanes are invisible to per-hop combines (a literal ``0`` corrupts
    non-add monoids: ``min`` over zeros clamps negative data, ``prod``
    annihilates).
    """
    d = ambient().rank_ndim
    size = x.shape[d]
    rem = (-size) % n
    if rem:
        shape = tuple(x.shape[:d]) + (rem,) + tuple(x.shape[d + 1:])
        if monoid is not None:
            pad = monoid.identity(TensorSpec(shape, x.dtype, x.device))
        else:
            pad = torch.full(shape, fill, dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad], dim=d)
    return x, size


# ---------------------------------------------------------------------------
# Reduce-scatter  (rank i ends owning the fully-reduced chunk i)
# ---------------------------------------------------------------------------

def ring_reduce_scatter(
    x: torch.Tensor,
    axis_name: str,
    monoid: Monoid = ADD,
    *,
    hop_combine: Optional[Callable] = None,
) -> torch.Tensor:
    """Bandwidth-optimal ring reduce-scatter with a per-hop combine.

    ``hop_combine(incoming, local)`` is the in-switch aggregation program;
    it defaults to ``monoid.combine`` and may be any user function (ACiS
    Type 2) including a hand-written kernel — one call per hop covers every
    rank.  Each rank's ``x`` is [n * chunk, ...]; the result is its fully
    reduced chunk ``i`` of shape [chunk, ...].
    """
    tp = current()
    n = tp.axis_size(axis_name)
    combine = hop_combine or monoid.combine
    if n == 1:
        return x
    i = tp.axis_index(axis_name)
    xs = _split_chunks(x, n)
    buf = tp.take(xs, (i - 1) % n)
    for s in range(n - 1):
        incoming = tp.shift(buf, axis_name, 1)
        local = tp.take(xs, (i - 2 - s) % n)
        buf = combine(incoming, local)
    return buf


# ---------------------------------------------------------------------------
# All-gather  (rank i contributes chunk i; result is [n * chunk, ...])
# ---------------------------------------------------------------------------

def ring_all_gather(
    x: torch.Tensor,
    axis_name: str,
    *,
    hop_map: Optional[Callable] = None,
) -> torch.Tensor:
    """Bandwidth-optimal ring all-gather.

    ``hop_map`` (ACiS Type 4 "map" fused into the collective) is applied
    to every chunk exactly once, as it is *forwarded*; the result at
    every rank is ``concat([map(chunk_0), ..., map(chunk_{n-1})])``.
    """
    tp = current()
    n = tp.axis_size(axis_name)
    if hop_map is None:
        hop_map = lambda c: c  # noqa: E731
    if n == 1:
        return hop_map(x)
    i = tp.axis_index(axis_name)
    d = tp.rank_ndim
    first = hop_map(x)
    out = first.new_zeros(tuple(first.shape[:d]) + (n,)
                          + tuple(first.shape[d:]))
    tp.put(out, i, first)
    buf = first
    for s in range(n - 1):
        buf = tp.shift(buf, axis_name, 1)
        tp.put(out, (i - 1 - s) % n, buf)
    return out.reshape(tuple(first.shape[:d]) + (n * first.shape[d],)
                       + tuple(first.shape[d + 1:]))


# ---------------------------------------------------------------------------
# All-reduce
# ---------------------------------------------------------------------------

def ring_all_reduce(
    x: torch.Tensor,
    axis_name: str,
    monoid: Monoid = ADD,
    *,
    hop_combine: Optional[Callable] = None,
    latency_optimal: bool = False,
) -> torch.Tensor:
    """All-reduce with per-hop combine.

    ``latency_optimal=False`` (default): reduce-scatter ∘ all-gather —
    2(n-1) hops of ``size/n`` each (bandwidth-optimal).
    ``latency_optimal=True``: n-1 hops of full-size messages with a
    combine at every hop (the paper's small-message regime).
    """
    tp = current()
    n = tp.axis_size(axis_name)
    if n == 1:
        return x
    combine = hop_combine or monoid.combine
    if latency_optimal:
        # rotate each rank's *original* contribution around the ring and
        # fold it into a local accumulator; requires a commutative monoid
        acc, msg = x, x
        for _ in range(n - 1):
            msg = shift_tree(msg, axis_name, 1)
            acc = combine(acc, msg)
        return acc

    shape = tp.local_shape(x)
    flat = tp.flatten_local(x)
    padded, size = pad_to_multiple(flat, n, monoid=monoid)
    red = ring_reduce_scatter(padded, axis_name, monoid,
                              hop_combine=hop_combine)
    full = ring_all_gather(red, axis_name)
    return tp.reshape_local(full[..., :size], shape)


# ---------------------------------------------------------------------------
# Broadcast (multicast engine)
# ---------------------------------------------------------------------------

def ring_broadcast(x: torch.Tensor, axis_name: str,
                   root: int = 0) -> torch.Tensor:
    """Ring multicast: the value is replicated hop by hop along the ring,
    mirroring the paper's packet-replication engine."""
    tp = current()
    n = tp.axis_size(axis_name)
    if n == 1:
        return x
    d = (tp.axis_index(axis_name) - root) % n   # ring distance from root
    buf = torch.where(tp.rank_bcast(d == 0, x), x, torch.zeros_like(x))
    for s in range(n - 1):
        incoming = tp.shift(buf, axis_name, 1)
        buf = torch.where(tp.rank_bcast(d == s + 1, x), incoming, buf)
    return buf


def tree_broadcast(x: torch.Tensor, axis_name: str,
                   root: int = 0) -> torch.Tensor:
    """Log-step (binomial-tree) multicast — beyond-paper latency option."""
    tp = current()
    n = tp.axis_size(axis_name)
    if n == 1:
        return x
    d = (tp.axis_index(axis_name) - root) % n
    buf = torch.where(tp.rank_bcast(d == 0, x), x, torch.zeros_like(x))
    k = 1
    while k < n:
        # ranks with d < k hold the value; they send to d + k
        incoming = tp.shift(buf, axis_name, k)
        take = (d >= k) & (d < 2 * k)
        buf = torch.where(tp.rank_bcast(take, x), incoming, buf)
        k *= 2
    return buf


# ---------------------------------------------------------------------------
# Rank prefix scan — the Type 3 look-aside carry walking the network.
# ---------------------------------------------------------------------------

def rank_prefix_scan(
    x: PyTree,
    axis_name: str,
    monoid: Monoid = ADD,
    *,
    exclusive: bool = False,
) -> PyTree:
    """Prefix scan *across ranks* (per-rank pytrees combined in rank
    order).  Log-step Hillis-Steele: ceil(log2 n) shift rounds; works for
    any (possibly non-commutative) associative monoid and any axis size.
    """
    tp = current()
    n = tp.axis_size(axis_name)
    i = tp.axis_index(axis_name)
    acc = x
    k = 1
    while k < n:
        shifted = tree.tree_map(
            lambda l, _k=k: _partial_shift(l, axis_name, _k), acc)
        valid = i >= k
        combined = monoid.combine(shifted, acc)
        acc = tree.tree_map(
            lambda c, a: torch.where(tp.rank_bcast(valid, c), c, a),
            combined, acc)
        k *= 2
    if not exclusive:
        return acc
    # exclusive_i = inclusive_{i-1};  rank 0 takes the identity.
    prev = tree.tree_map(lambda l: _partial_shift(l, axis_name, 1), acc)
    ident = monoid.identity(tree.tree_map(
        lambda l: TensorSpec(tuple(l.shape), l.dtype, l.device), x))
    return tree.tree_map(
        lambda p, e: torch.where(tp.rank_bcast(i == 0, p), e, p),
        prev, ident)


# ---------------------------------------------------------------------------
# All-to-all (shifted hops) — substrate for fused AR+A2A (NAS IS).
# ---------------------------------------------------------------------------

def ring_all_to_all(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """All-to-all: each rank's ``x`` is [n * chunk, ...]; chunk j goes to
    rank j.  n-1 shifted hops of one chunk each, so per-hop compute can
    be interleaved by callers."""
    tp = current()
    n = tp.axis_size(axis_name)
    if n == 1:
        return x
    i = tp.axis_index(axis_name)
    xs = _split_chunks(x, n)
    out = torch.zeros_like(xs)
    tp.put(out, i, tp.take(xs, i))          # the local chunk stays
    for s in range(1, n):
        # send the chunk destined for rank (i + s); receive the one
        # destined for us from rank (i - s)
        send = tp.take(xs, (i + s) % n)
        recv = tp.shift(send, axis_name, s)
        tp.put(out, (i - s) % n, recv)
    return out.reshape(x.shape)


def ring_gather(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Gather: every rank computes the gathered value; "root" semantics are
    realized by callers discarding non-root outputs."""
    return ring_all_gather(x, axis_name)
