"""ACiS Type 4 — fused collectives and collective∘map fusion.

The PyTorch counterpart of :mod:`repro.core.fused`.  The paper's Type 4
builds new operations by fusing chains of collectives ("recirculate
interface") or sandwiching map computation between them (the CGRA
program).  The value: intermediate communications are bypassed and the
sandwiched compute happens *in the network*, not at the endpoints.

Implemented fusions (each with its unfused endpoint-compute baseline so
benchmarks/tests can compare like-for-like):

  * allgather_op_allgather   — paper Fig. 5 (op = prefix sum, FEM pattern)
  * fused_allreduce_alltoall — NAS IS pattern (paper §II Type 4 example)
  * map_reduce_scatter / allgather_map — MapReduce pattern
  * allgather_matmul / matmul_reduce_scatter — "collective matmul":
    the map is a matmul shard and each hop's compute hides the next hop's
    communication (the production-relevant Type 4 for tensor parallelism).

All functions are rank-local (inside ``with mesh:``): every operand
carries the rank dims in front, ``[*rank, *local]``.  A rank-dependent
``dynamic_*`` index becomes a per-rank gather or scatter
(:meth:`~repro_torch.mesh.Transport.take` / ``put``), ``lax.scan`` over
the hops a Python loop, and a matmul batches over the rank dims.  Only
``allgather_op_allgather`` reaches a kernel (``prefix_sum``, under
``use_kernels``); the others combine with plain tensor ops, as the
reference's do.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import collectives, ring
from repro_torch.core.lookaside import distributed_prefix_sum
from repro_torch.core.types import ADD, Monoid
from repro_torch.core.wire import IDENTITY, WireCodec
from repro_torch.mesh import current


# ---------------------------------------------------------------------------
# Fig. 5: Allgather_op_Allgather  (op = prefix sum)
# ---------------------------------------------------------------------------

def allgather_op_allgather_baseline(x: torch.Tensor,
                                    axis_name: str) -> torch.Tensor:
    """Endpoint-compute baseline (the MPI4py pattern of paper Fig. 5):
    allgather the blocks, compute the op at every endpoint, allgather the
    (locally relevant slice of the) result again.  Two full collective
    rounds + redundant endpoint compute."""
    tp = current()
    n = tp.axis_size(axis_name)
    i = tp.axis_index(axis_name)
    gathered = collectives.all_gather(x, axis_name, backend="xla")
    scanned = torch.cumsum(gathered, dim=tp.rank_ndim)
    # second round: each rank re-shares "its" slice of the result —
    # the redundant communication the fusion deletes.
    mine = tp.take(ring._split_chunks(scanned, n), i)
    return collectives.all_gather(mine, axis_name, backend="xla")


def allgather_op_allgather(x: torch.Tensor, axis_name: str, *,
                           use_kernels: bool = False) -> torch.Tensor:
    """Fused version: the prefix-sum carry is computed *in the network*
    (log-step rank scan) and only the finished blocks are gathered — one
    gather round instead of two, no redundant endpoint compute.  The
    local scan runs the ``prefix_sum`` kernel under ``use_kernels``."""
    scanned_local = distributed_prefix_sum(x, axis_name,
                                           use_kernels=use_kernels)
    return ring.ring_all_gather(scanned_local, axis_name)


def scan_then_allgather(x: torch.Tensor, axis_name: str,
                        monoid: Monoid = ADD, *,
                        exclusive: bool = False) -> torch.Tensor:
    """Generalized Fig. 5 fusion: cross-rank ``monoid`` prefix scan with the
    finished blocks gathered in the same program — one gather round for any
    user-defined (Type 2) scan op, not just the prefix-sum special case."""
    scanned = collectives.prefix_scan(x, axis_name, monoid,
                                      exclusive=exclusive)
    return ring.ring_all_gather(scanned, axis_name)


# ---------------------------------------------------------------------------
# NAS IS: AllReduce (histogram) + AlltoAll (keys), fused on one schedule
# ---------------------------------------------------------------------------

def allreduce_alltoall_baseline(hist: torch.Tensor, keys: torch.Tensor,
                                axis_name: str
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential baseline: finish the allreduce, then start the alltoall."""
    h = collectives.all_reduce(hist, axis_name, ADD, backend="xla")
    k = collectives.all_to_all(keys, axis_name, backend="xla")
    return h, k


def fused_allreduce_alltoall(hist: torch.Tensor, keys: torch.Tensor,
                             axis_name: str, *,
                             hop_combine: Optional[Callable] = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused schedule: the histogram reduction hops ride the same loop as
    the key-chunk exchange, so the (small) histogram combine hides behind
    the (large) key transfer at every hop — one traversal of the ring does
    both jobs (the paper's IS observation: "ACiS can take advantage of
    communication-computation overlap and in-network data reduction").
    ``hop_combine(acc, incoming)`` folds each histogram hop (the add by
    default; Emit passes the ``fused_combine`` kernel's hook under
    ``use_kernels``)."""
    tp = current()
    n = tp.axis_size(axis_name)
    if n == 1:
        return hist, keys
    i = tp.axis_index(axis_name)
    ks = ring._split_chunks(keys, n)
    out = torch.zeros_like(ks)
    tp.put(out, i, tp.take(ks, i))

    hacc, hmsg = hist, hist
    for s in range(1, n):
        send = tp.take(ks, (i + s) % n)
        recv = tp.shift(send, axis_name, s)               # key chunk hop
        tp.put(out, (i - s) % n, recv)
        # histogram combine hop rides the same loop iteration (n-1 hops
        # total): rotate original contributions, fold into accumulator.
        hmsg = tp.shift(hmsg, axis_name, 1)
        hacc = hacc + hmsg if hop_combine is None \
            else hop_combine(hacc, hmsg)
    # after n-1 latency-ring hops every rank has the full histogram sum
    return hacc, out.reshape(keys.shape)


# ---------------------------------------------------------------------------
# MapReduce fusions
# ---------------------------------------------------------------------------

def map_reduce_scatter(x: torch.Tensor, axis_name: str,
                       map_fn: Callable[[torch.Tensor], torch.Tensor],
                       monoid: Monoid = ADD,
                       codec: WireCodec = IDENTITY) -> torch.Tensor:
    """map ∘ reduce-scatter in one schedule: the map is applied to each
    chunk right before it enters the ring (no full-size intermediate)."""
    mapped = map_fn(x)
    return collectives.reduce_scatter(mapped, axis_name, monoid, codec=codec)


def allgather_map(x: torch.Tensor, axis_name: str,
                  map_fn: Callable[[torch.Tensor], torch.Tensor]
                  ) -> torch.Tensor:
    """all-gather ∘ map with the map applied in-flight (once per chunk, at
    the forwarding hop) instead of n times at every endpoint."""
    return ring.ring_all_gather(x, axis_name, hop_map=map_fn)


# ---------------------------------------------------------------------------
# Collective matmul (overlapped TP matmuls — the production Type 4)
# ---------------------------------------------------------------------------

def allgather_matmul(x_local: torch.Tensor, w_local: torch.Tensor,
                     axis_name: str) -> torch.Tensor:
    """y = allgather(x) @ w_local, overlapped.

    x_local: [m_loc, k] (row shard), w_local: [k, n_loc] (col shard of W).
    Result: [m_loc * n_ranks, n_loc].  Each hop's matmul hides the next
    block's rotation — the matmul happens "in the network".  Autograd
    differentiates it: each hop's block is an index put into a fresh
    buffer.
    """
    tp = current()
    n = tp.axis_size(axis_name)
    i = tp.axis_index(axis_name)
    d = tp.rank_ndim
    m_loc = x_local.shape[d]
    rank = tuple(x_local.shape[:d])
    out = x_local.new_zeros(rank + (n, m_loc, w_local.shape[-1]))
    blk = x_local
    for s in range(n - 1):
        owner = (i - s) % n
        y = blk @ w_local                              # compute current block...
        blk = tp.shift(blk, axis_name, 1)              # ...while rotating
        tp.put(out, owner, y)
    owner = (i - (n - 1)) % n
    tp.put(out, owner, blk @ w_local)
    return out.reshape(rank + (n * m_loc, w_local.shape[-1]))


def _col_blocks(w: torch.Tensor, n: int) -> torch.Tensor:
    """``[*rank, k, N]`` → ``[*rank, n, k, N // n]``: the n column blocks
    of width N // n (trailing columns past n · (N // n) dropped, as
    ``dynamic_slice`` never reaches them)."""
    k, cols = w.shape[-2:]
    nc = cols // n
    wb = w.narrow(-1, 0, n * nc).reshape(tuple(w.shape[:-1]) + (n, nc))
    return wb.movedim(-2, -3)


def matmul_reduce_scatter(x_local: torch.Tensor, w_local: torch.Tensor,
                          axis_name: str) -> torch.Tensor:
    """y = reduce_scatter(x_local @ w_local), overlapped.

    x_local: [m, k_loc], w_local: [k_loc, N] with N divisible by n_ranks.
    Result: [m, N / n_ranks] — rank i owns column block i, fully reduced.
    The partial matmul for each column block is computed just-in-time as
    the accumulating buffer arrives (compute hides communication).
    """
    tp = current()
    n = tp.axis_size(axis_name)
    i = tp.axis_index(axis_name)
    if n == 1:
        return x_local @ w_local
    wb = _col_blocks(w_local, n)

    def partial(c):
        return x_local @ tp.take(wb, c)

    buf = partial((i - 1) % n)
    for s in range(n - 1):
        incoming = tp.shift(buf, axis_name, 1)
        buf = incoming + partial((i - 2 - s) % n)
    return buf


def allgather_matmul_baseline(x_local: torch.Tensor, w_local: torch.Tensor,
                              axis_name: str) -> torch.Tensor:
    x = collectives.all_gather(x_local, axis_name, backend="xla")
    return x @ w_local


def matmul_reduce_scatter_baseline(x_local: torch.Tensor,
                                   w_local: torch.Tensor,
                                   axis_name: str) -> torch.Tensor:
    """Unfused baseline: full partial matmul, then a separate reduce-scatter."""
    y = x_local @ w_local
    return _rs_cols(y, axis_name)


def _rs_cols(y: torch.Tensor, axis_name: str) -> torch.Tensor:
    """reduce-scatter over column blocks (``psum_scatter``): rank i gets
    the sum over the axis's ranks of column block i."""
    tp = current()
    yb = _col_blocks(y, tp.axis_size(axis_name))       # [*rank, n, m, nc]
    return collectives.reduce_scatter(yb, axis_name, backend="xla") \
        .squeeze(tp.rank_ndim)
