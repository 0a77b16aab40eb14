"""ACiS Type 3 — look-aside operators: state + loops + off-chip memory.

The PyTorch counterpart of :mod:`repro.core.lookaside`.  The paper's Type
3 gives the data plane direct access to off-chip memory so operations
can be *stateful* and contain *loops*; on the card the state is
device-resident and threaded through the collective:

  * :func:`error_feedback_all_reduce` — compressed gradient sync whose
    residual memory persists across steps (error feedback, EF), over
    :func:`compressed_all_reduce` (``(total, delivered)``, what the
    compiler's ``ef_allreduce`` stage runs) with three compressors, one
    of them :func:`shared_scale_quant_all_reduce`; :func:`init_residual`
  * :func:`powersgd_all_reduce` — an iterative low-rank loop *inside* the
    collective (power iteration), with the Q factor as persistent state
    (:func:`powersgd_init`)
  * :func:`distributed_prefix_sum` — the scan carry walks the network;
    the local scan of the compiler's ``scan+allgather`` stage
  * :func:`gcn_aggregate` — the paper's own Type 3 case study (FLASH,
    ICS'23): neighbor aggregation where remote feature blocks stream past
    a device-resident accumulator, hop by hop

All functions are rank-local (inside ``with mesh:``, rank dims in
front).  ``use_kernels`` routes work through the hand-written kernels:
``quant_combine`` for the ``int8_hopquant`` hop combine,
``topk_accumulate`` for ``topk``, ``prefix_sum`` for the local scan of
:func:`distributed_prefix_sum`; the shared-scale ``int8`` ring adds
int16 partials and has no kernel, and PowerSGD and the GCN MACs are
plain matmuls, as the reference leaves them to XLA.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree
from repro_torch.core import collectives, ring, switchops
from repro_torch.core.compression import (TopK, orthonormalize,
                                          sparse_all_reduce_payloads)
from repro_torch.core.types import ADD, MAX as MAX_MONOID
from repro_torch.core.wire import block_scale, int8_codec
from repro_torch.mesh import current

PyTree = Any


# ---------------------------------------------------------------------------
# Shared-scale integer quantized all-reduce (SwitchML/SHArP-style).
#
# Per-hop *re*-quantization (wire.int8_codec) loses precision that no rank's
# error-feedback memory can account for.  The in-switch aggregators that ship
# (SwitchML, SHArP streaming-aggregation) instead agree on a scale up front
# and accumulate integers exactly.  We do the same: a tiny max-allreduce
# fixes a shared per-block scale, contributions are int8-granular, and the
# ring carries int16 partials (exact for axis sizes <= 256).  The only loss
# is each rank's own initial rounding — exactly what EF captures.
# ---------------------------------------------------------------------------

QBLOCK = 256


def shared_scale_quant_all_reduce(
    x: torch.Tensor, axis_name: str, *, block: int = QBLOCK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (sum_over_ranks(round(x)), delivered_self) — both decoded."""
    tp = current()
    shape = tp.local_shape(x)
    flat = tp.flatten_local(x).to(torch.float32)
    size = flat.shape[-1]
    pad = (-size) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(flat.shape[:-1] + (pad,))],
                         dim=-1)
    blocks = flat.reshape(flat.shape[:-1] + (-1, block))
    absmax = blocks.abs().amax(dim=-1)
    # shared scale: small latency-optimal max-allreduce (1/block of payload)
    absmax = collectives.all_reduce(absmax, axis_name, MAX_MONOID,
                                    latency_optimal=True)
    scale = block_scale(absmax)
    q = torch.clamp(torch.round(blocks / scale[..., None]),
                    -127, 127).to(torch.int16)
    delivered_self = tp.flatten_local(
        q.to(torch.float32) * scale[..., None])[..., :size]

    # exact integer ring RS∘AG: combine = int16 add (no loss at any hop)
    qsum = collectives._tree_all_reduce_encoded(
        (q,), axis_name, lambda a, b: (a[0] + b[0],))[0]
    total = tp.flatten_local(qsum.to(torch.float32) * scale[..., None])
    total = total[..., :size]
    return tp.reshape_local(total, shape), \
        tp.reshape_local(delivered_self, shape)


def compressed_all_reduce(
    target: torch.Tensor,
    axis_name: str,
    *,
    compressor: str = "int8",
    topk_ratio: float = 0.01,
    use_kernels: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One lossy all-reduce: returns ``(total, delivered)``.

    ``total`` is the (sum, not mean) reduction in ``target``'s dtype;
    ``delivered`` is what the lossy wire delivered of *this rank's*
    contribution, in f32 and ``target``'s shape — the caller forms the
    error-feedback residual as ``target - delivered``.  This is the
    primitive behind both :func:`error_feedback_all_reduce` and the
    compiler's ``ef_allreduce`` stage (the REDUCE+DELIVERED pair).

    Compressors:
      * ``int8``          — shared-scale exact-integer accumulation (default;
                            EF identity exact; wire ≈ 0.5x of f32)
      * ``int8_hopquant`` — per-hop dequant-add-requant (wire ≈ 0.25x; adds
                            bounded, EF-invisible hop noise); the hop
                            combine is the ``quant_combine`` kernel under
                            ``use_kernels``
      * ``topk``          — sparse (idx, val) payloads, in-network
                            scatter-accumulate; the ``topk_accumulate``
                            kernel under ``use_kernels``
    """
    tp = current()
    tf = target.to(torch.float32)
    if compressor == "int8":
        total, delivered = shared_scale_quant_all_reduce(tf, axis_name)
    elif compressor == "int8_hopquant":
        codec = int8_codec(use_kernels=use_kernels)
        total = collectives.all_reduce(tf, axis_name, ADD, codec=codec)
        # what the wire actually delivered for *our* contribution:
        delivered = codec.decode(codec.encode(tf))
    elif compressor == "topk":
        shape = tp.local_shape(target)
        flat = tp.flatten_local(tf)
        k = max(1, int(flat.shape[-1] * topk_ratio))
        tk = TopK(k)
        idx, vals = tk.compress(flat)
        total = tp.reshape_local(sparse_all_reduce_payloads(
            idx, vals, axis_name, flat.shape[-1], dtype=torch.float32,
            use_kernels=use_kernels), shape)
        delivered = tk.decompress((idx, vals), shape, torch.float32,
                                  use_kernels=use_kernels)
    else:
        raise ValueError(f"unknown compressor {compressor!r}")
    return total.to(target.dtype), delivered


def error_feedback_all_reduce(
    x: torch.Tensor,
    residual: torch.Tensor,
    axis_name: str,
    *,
    compressor: str = "int8",
    topk_ratio: float = 0.01,
    mean: bool = True,
    use_kernels: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All-reduce ``x`` through a lossy wire format with error feedback.

    Returns ``(reduced, new_residual)``.  The residual is the Type 3
    look-aside memory: it must be carried by the caller across invocations
    (the training loop stores it next to the optimizer state).  Thin
    wrapper over :func:`compressed_all_reduce`.
    """
    n = current().axis_size(axis_name)
    target = x + residual.to(x.dtype)
    reduced, delivered = compressed_all_reduce(
        target, axis_name, compressor=compressor, topk_ratio=topk_ratio,
        use_kernels=use_kernels)
    new_residual = (target.to(torch.float32) - delivered).to(residual.dtype)
    if mean:
        reduced = reduced / n
    return reduced, new_residual


def init_residual(params: PyTree, dtype=torch.float32) -> PyTree:
    """Zero residuals shaped like ``params`` (rank-stacked tensors keep
    their rank dims) on the same devices."""
    return tree.tree_map(
        lambda p: torch.zeros(tuple(p.shape), dtype=dtype, device=p.device),
        params)


# ---------------------------------------------------------------------------
# PowerSGD — the loop lives inside the collective (Type 3 "can have loops")
# ---------------------------------------------------------------------------

def powersgd_all_reduce(
    m: torch.Tensor,
    q: torch.Tensor,
    residual: torch.Tensor,
    axis_name: str,
    *,
    mean: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-r all-reduce of a matrix ``m`` [rows, cols] via power iteration.

    ``q`` [cols, r] is the persistent warm-start factor (look-aside state),
    ``residual`` the error-feedback memory.  Two small all-reduces of the
    factors replace one big all-reduce of the matrix:
    wire bytes r·(rows+cols) vs rows·cols.  Every operand carries the rank
    dims in front; the matmuls batch over them.

    Returns (reduced_mean, new_q, new_residual).
    """
    n = current().axis_size(axis_name)
    target = (m + residual.to(m.dtype)).to(torch.float32)

    # -- the in-collective loop (power iteration) --
    p = target @ q                                     # [rows, r]
    p = collectives.all_reduce(p, axis_name, ADD)      # small wire
    p = orthonormalize(p)
    new_q = target.mT @ p                              # [cols, r]
    new_q = collectives.all_reduce(new_q, axis_name, ADD)
    approx = p @ new_q.mT                              # decoded mean*n
    reduced = approx / n if mean else approx

    delivered_local = p @ (target.mT @ p).mT           # our contribution as seen
    new_residual = (target - delivered_local).to(residual.dtype)
    return reduced.to(m.dtype), new_q, new_residual


def powersgd_init(shape, rank: int,
                  generator: torch.Generator) -> torch.Tensor:
    """A standard-normal warm start ``[cols, rank]`` for a ``[rows, cols]``
    matrix, drawn from ``generator`` on its device (not ``jax.random``'s
    bits: tests that compare with the reference hand both the same
    ``q``)."""
    cols = shape[1]
    return torch.randn((cols, rank), generator=generator,
                       dtype=torch.float32, device=generator.device)


# ---------------------------------------------------------------------------
# Distributed prefix sum (the FEM op of paper Fig. 5)
# ---------------------------------------------------------------------------

def distributed_prefix_sum(x: torch.Tensor, axis_name: str, *,
                           exclusive: bool = False,
                           use_kernels: bool = False) -> torch.Tensor:
    """Global prefix sum over the rank-major concatenation of local blocks.

    Local inclusive scan + cross-rank exclusive scan of block totals (the
    carry walks the network log-step).  Sub-block of the fused
    allgather_op_allgather (core/fused.py).  The local scan is the
    ``prefix_sum`` switch op along the first local dim, one call for
    every rank — the CUDA kernel under ``use_kernels``.
    """
    tp = current()
    d = tp.rank_ndim
    op = switchops.get("prefix_sum", load=use_kernels)
    local = op(x, dim=d, use_kernel=use_kernels)
    total = local.select(d, -1) if x.shape[d] else \
        torch.zeros(x.shape[:d] + x.shape[d + 1:], dtype=x.dtype,
                    device=x.device)
    carry = ring.rank_prefix_scan(total, axis_name, ADD,
                                  exclusive=True).unsqueeze(d)
    inc = local + carry
    if not exclusive:
        return inc
    # rank-local `inc[:-1]`: an empty block still yields its carry row
    return torch.cat([carry, inc[(slice(None),) * d + (slice(None, -1),)]],
                     dim=d)


# ---------------------------------------------------------------------------
# GCN neighbor aggregation (paper Fig. 4 case study)
# ---------------------------------------------------------------------------

def gcn_aggregate(
    adj_blocks: torch.Tensor,
    x_local: torch.Tensor,
    axis_name: str,
    *,
    in_network: bool = True,
    backend: str = "acis",
) -> torch.Tensor:
    """Aggregate neighbor features  out = Â @ X  with X row-sharded.

    ``adj_blocks`` [n_ranks, rows_local, cols_block] — the local rows of the
    (normalized) adjacency, blocked by owner of the corresponding X rows.
    ``x_local`` [cols_block, d] — this rank's feature rows.

    in_network=True: ring-rotate the feature block; each hop performs a
    block-MAC against the device-resident accumulator (look-aside memory)
    — full X is never materialized, and compute overlaps the rotation.
    The block a rank needs at a hop depends on its rank, so the gather is
    per rank (:meth:`~repro_torch.mesh.Transport.take`) and the MAC one
    matmul batched over the rank dims.
    in_network=False (baseline): all-gather X, then one big SpMM — the
    endpoint-compute pattern of a passive network.
    """
    tp = current()
    n = tp.axis_size(axis_name)
    i = tp.axis_index(axis_name)
    rank = tuple(x_local.shape[:tp.rank_ndim])

    if not in_network:
        full_x = collectives.all_gather(x_local, axis_name, backend=backend)
        full_x = full_x.reshape(rank + (n,) + tuple(x_local.shape[-2:]))
        # out = sum_b adj_blocks[b] @ full_x[b]
        return torch.einsum("...brc,...bcd->...rd", adj_blocks, full_x)

    acc = x_local.new_zeros(rank + (adj_blocks.shape[-2],
                                    x_local.shape[-1]))
    blk = x_local
    for s in range(n - 1):
        owner = (i - s) % n          # whose X block we currently hold
        acc = acc + tp.take(adj_blocks, owner) @ blk   # per-hop MAC
        blk = tp.shift(blk, axis_name, 1)
    owner = (i - (n - 1)) % n
    return acc + tp.take(adj_blocks, owner) @ blk
