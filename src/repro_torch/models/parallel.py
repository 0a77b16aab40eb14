"""Tensor-parallel hook — how serving communication reaches the models.

The port of :mod:`repro.models.parallel`.  The decode/prefill math in
``models/decode.py`` / ``models/transformer.py`` / ``models/moe.py`` is
written rank-local: under tensor parallelism each rank holds a column
slice of wq/wk/wv/wi (so attention and FFN partials are *partial sums*
after wo) and a slice of the expert stack (so the MoE slot tensor must be
resharded group-major -> expert-major).  Where those partials need the
network, the model consults the active :class:`TensorParallel` hook
instead of calling a collective directly — so the same model code runs

  * unsharded (no hook installed),
  * rank-local on a :class:`~repro_torch.mesh.LocalMesh`, every rank's
    slice stacked in one tensor, with the hook supplying the
    communication — the plain reduction over the rank dim, direct acis
    rings, or compiled switch programs (:mod:`repro_torch.serve.
    collectives`).

The port runs eagerly: the hook is consulted at *run* time, on every call
of the model function inside ``with tensor_parallel(hook):``, where the
reference consults it once, while ``jit`` traces the decode program.  A
hook that looks up compiled programs should therefore make that lookup
cheap (``CompiledTPHook`` keeps a dict of the tick's programs).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

# Active-hook stack, consulted at call time.
_ACTIVE: list["TensorParallel"] = []


class TensorParallel:
    """Communication points the models expose under tensor parallelism.

    The base class is the identity hook — every method returns its input
    unchanged — so model code may call the active hook unconditionally.
    Subclasses (see :mod:`repro_torch.serve.collectives`) override the
    methods with real collectives over their mesh axis.  Tensors are
    rank-stacked (``[*rank, ...]``) inside a mesh.
    """

    def attn_reduce(self, h: torch.Tensor) -> torch.Tensor:
        """Sum attention-output partials [B, T, D] (after the sliced wo)."""
        return h

    def ffn_reduce(self, f: torch.Tensor) -> torch.Tensor:
        """Sum dense-FFN output partials [B, T, D] (after the sliced wo)."""
        return f

    def layer_params(self, pp, where: tuple):
        """One period of the stacked layers as the period computes with
        it: ``pp`` is the period's view of the stacked subtree at path
        ``where`` (``("layers",)``, an encoder's ``("enc", "layers")``).
        The identity here; an FSDP hook gathers the period's shards, one
        period at a time."""
        return pp

    def moe_aux_means(self, me: torch.Tensor, ce: torch.Tensor):
        """The load-balance loss's per-expert means ``[..., E]`` (router
        probability, top-1 share) over this rank's tokens.  The identity
        here; a hook whose ranks split one global batch (the GSPMD step)
        returns their means over that batch, as the reference's global
        program computes them."""
        return me, ce

    def moe_route_input(self, xt: torch.Tensor) -> torch.Tensor:
        """The tokens the MoE router reads [..., G, Ng, D]: every rank
        must route each token alike, since the dispatch and combine move
        one slot layout between them."""
        return xt

    def moe_dispatch(self, xem: torch.Tensor) -> torch.Tensor:
        """Reshard the MoE slot tensor expert-major: [E, S, D] with every
        rank holding all tokens -> [E/tp, S, D] rows of this rank's
        experts (the group->expert all-to-all)."""
        return xem

    def moe_combine(self, yem: torch.Tensor,
                    shared_partial: Optional[torch.Tensor] = None):
        """Inverse reshard of expert outputs [E/tp, S, D] -> [E, S, D]
        (every rank again sees all experts' outputs), optionally fused
        with the all-reduce of the shared-expert partial — the Type-4
        AR+A2A pair.  Returns ``(yem_full, shared_reduced)`` where
        ``shared_reduced`` is None iff ``shared_partial`` was."""
        return yem, shared_partial


def current() -> Optional[TensorParallel]:
    """The innermost installed hook, or None (run unhooked)."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def tensor_parallel(hook: TensorParallel):
    """Install ``hook`` for model calls made inside the block."""
    _ACTIVE.append(hook)
    try:
        yield hook
    finally:
        _ACTIVE.pop()
