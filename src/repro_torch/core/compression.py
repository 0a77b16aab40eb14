"""Gradient/payload compression — the ACiS Type 2 "user-defined datatypes".

The PyTorch counterpart of :mod:`repro.core.compression`.  Three wire
datatypes beyond primitives:

  * top-k sparse        — (indices, values) pairs; the sparse-accumulation
                          datatype the paper calls out P4 switches for
                          lacking (§III: "no sparse data types").
  * blockwise int8      — payload + scales (see :mod:`repro_torch.core.wire`).
  * low-rank (PowerSGD) — rank-r factor pair, for the Type 3 iterative
                          loop (``lookaside.powersgd_*``).

Rank-local like the rest of ``core``: inside ``with mesh:`` every tensor
carries the rank dims in front and each rank compresses its own payload.
The scatter-accumulates go through the ``topk_accumulate`` instruction of
the switch-op registry (:mod:`repro_torch.core.switchops`) and take
``use_kernels``: on, a CUDA accumulator runs the hand-written kernel
(:mod:`repro_torch.kernels.topk_accum`); off, or on the CPU, its plain
version.  Both update the ring's accumulator in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import ring, switchops
from repro_torch.mesh import ambient, current

PyTree = Any


# ---------------------------------------------------------------------------
# Top-k sparsification
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TopK:
    """Keep the k largest-magnitude entries of each rank's flat payload."""

    k: int

    def compress(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(idx int32, vals)`` per rank, ``[*rank, k]``, in the order
        ``jax.lax.top_k`` gives: by magnitude, largest first, and among
        equal magnitudes the lower index first.  ``torch.topk`` promises
        no order for ties, and bf16 gradients have many at a 1% cut, so
        the selection is a stable descending sort."""
        flat = ambient().flatten_local(x)
        k = min(self.k, flat.shape[-1])
        order = torch.sort(flat.abs(), dim=-1, descending=True,
                           stable=True).indices[..., :k]
        return order.to(torch.int32), flat.gather(-1, order)

    def decompress(self, payload: tuple[torch.Tensor, torch.Tensor],
                   shape, dtype, *, use_kernels: bool = False
                   ) -> torch.Tensor:
        idx, vals = payload
        size = 1
        for s in shape:
            size *= s
        tp = ambient()
        dense = torch.zeros(tp.rank_shape + (size,), dtype=dtype,
                            device=idx.device)
        sparse_accumulate_(dense, idx, vals.to(dtype),
                           use_kernels=use_kernels)
        return tp.reshape_local(dense, shape)

    def wire_bytes(self, shape) -> int:
        k = self.k
        return k * (4 + 4)  # int32 idx + f32 val


def sparse_accumulate_(dense: torch.Tensor, idx: torch.Tensor,
                       vals: torch.Tensor, *,
                       use_kernels: bool = False) -> torch.Tensor:
    """Scatter-add a sparse (idx, vals) payload into a dense accumulator,
    **in place**, rank by rank — the per-hop combine of the sparse
    all-reduce.  ``vals`` must already have ``dense``'s dtype."""
    op = switchops.get("topk_accumulate", load=use_kernels)
    return op(dense, idx, vals, use_kernel=use_kernels)


def sparse_accumulate(dense: torch.Tensor, idx: torch.Tensor,
                      vals: torch.Tensor, *,
                      use_kernels: bool = False) -> torch.Tensor:
    """The reference's functional form: ``dense`` with the payload added,
    as a new tensor."""
    return sparse_accumulate_(dense.clone(), idx, vals.to(dense.dtype),
                              use_kernels=use_kernels)


def sparse_all_reduce_payloads(idx: torch.Tensor, vals: torch.Tensor,
                               axis_name: str, dense_size: int,
                               dtype=torch.float32, *,
                               use_kernels: bool = False) -> torch.Tensor:
    """All-reduce of top-k sparse payloads: ring-rotate the (idx, val)
    pairs and scatter-accumulate at every hop into one dense accumulator
    per rank, ``[*rank, dense_size]``.

    Each rank adds its own payload first, then the one received at each
    of the n-1 hops, in the reference's order (its ``lax.scan`` over
    ``ppermute`` becomes a loop of one-step shifts), so every lane sums
    in the same order.  Bytes on the wire: (n-1) hops × 8k bytes, vs
    (n-1)/n × 4·size for a dense ring all-reduce.
    """
    tp = current()
    n = tp.axis_size(axis_name)
    acc = torch.zeros(tp.rank_shape + (dense_size,), dtype=dtype,
                      device=idx.device)
    vals = vals.to(dtype)
    sparse_accumulate_(acc, idx, vals, use_kernels=use_kernels)
    payload = (idx, vals)
    for _ in range(n - 1):
        payload = ring.shift_tree(payload, axis_name, 1)
        sparse_accumulate_(acc, *payload, use_kernels=use_kernels)
    return acc


# ---------------------------------------------------------------------------
# PowerSGD low-rank factors (for lookaside.powersgd_*)
# ---------------------------------------------------------------------------

def orthonormalize(p: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Gram-Schmidt columns of p [..., n, r] (r small); leading dims —
    the rank dims inside ``with mesh:`` — are batch."""
    p = p.clone()
    r = p.shape[-1]
    for i in range(r):
        col = p[..., i:i + 1]                          # [..., n, 1]
        prev = p * (torch.arange(r, device=p.device) < i)
        proj = prev @ (prev.mT @ col)
        col = col - proj
        p[..., i:i + 1] = col / (torch.linalg.vector_norm(
            col, dim=-2, keepdim=True) + eps)
    return p


def powersgd_wire_bytes(shape, rank: int) -> int:
    n, m = shape
    return 4 * rank * (n + m)
