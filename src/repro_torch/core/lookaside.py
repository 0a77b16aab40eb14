"""ACiS Type 3 — look-aside operators: state + loops + off-chip memory.

The PyTorch counterpart of :mod:`repro.core.lookaside`, gradient-sync
part: the compressed all-reduce whose residual memory persists across
steps (error feedback, EF), with its three compressors.

  * :func:`shared_scale_quant_all_reduce` — shared-scale exact integer ring
  * :func:`compressed_all_reduce` — one lossy all-reduce, ``(total,
    delivered)``; what the compiler's ``ef_allreduce`` stage runs
  * :func:`error_feedback_all_reduce`, :func:`init_residual`

The rest of the reference module — ``powersgd_*``,
``distributed_prefix_sum`` and ``gcn_aggregate`` — waits for the next
slice of the port, with ``core/fused.py`` and the ``prefix_sum`` kernel
(ROADMAP.md, queue 1).

All functions are rank-local (inside ``with mesh:``, rank dims in
front).  ``use_kernels`` routes the per-hop combines through the
hand-written kernels: ``quant_combine`` for ``int8_hopquant``,
``topk_accumulate`` for ``topk``; the shared-scale ``int8`` ring adds
int16 partials and has no kernel.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree
from repro_torch.core import collectives
from repro_torch.core.compression import TopK, sparse_all_reduce_payloads
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
