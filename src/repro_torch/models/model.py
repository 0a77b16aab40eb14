"""Model — the public facade over the port's models.

    model = Model(cfg)                                 # use_kernels=True
    params    = model.init(torch.Generator("cuda").manual_seed(0))
    hidden, aux = model.forward(params, tokens)        # train path
    logits    = model.logits(params, hidden)
    cache     = model.init_cache(batch, seq)
    lg, cache = model.prefill(params, tokens, cache)   # cache in place
    lg, cache = model.decode_step(params, token, cache, index)

The counterpart of :class:`repro.models.model.Model` for every family
of the reference's zoo: ``dense``, ``moe`` (GQA or MLA attention),
``ssm`` (RWKV-6), ``hybrid`` (RG-LRU + window attention), ``encdec``
(whisper) and ``vlm`` (llama vision).  The last two take a ``context``:
stub frame or patch embeddings of :meth:`Model.context_inputs`' shape,
which an encdec model runs through its encoder and a vlm model reads as
they are.  As the reference does, ``prefill`` and ``decode_step``
re-encode the context on every call.  Params and caches live on the card
unless the caller passes ``device=`` (the tests pass ``"cpu"``; ``"meta"``
gives shapes and dtypes without memory).  ``use_kernels=False`` runs every
kernel's plain PyTorch version instead, on any device — the engine's
convention, which ``chip_smoke.py`` uses to time both on the card.
``prefill`` and ``decode_step`` update the cache in place and return it;
clone it first to keep the old one.  ``forward`` is the training forward
(plain PyTorch under autograd, the config's remat policy; no kernel runs
there, as none does in the reference's): tokens, context and params may
carry rank dims in front (:mod:`repro_torch.train.step`).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.mesh import default_device
from repro_torch.models import decode as D
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

PyTree = Any


def _device(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


class Model:
    def __init__(self, cfg: ModelConfig, *, use_kernels: bool = True):
        self.cfg = cfg
        self.use_kernels = use_kernels

    # -- params --------------------------------------------------------------

    def init(self, generator: Optional[torch.Generator],
             device=None) -> PyTree:
        """Seeded random params; ``generator`` must live on ``device``
        (none is needed on ``meta``)."""
        return T.init_stack(generator, self.cfg, device=_device(device))

    def param_shapes(self) -> PyTree:
        return self.init(None, device="meta")

    # -- stub modality frontends (the backbone only) --------------------

    def context_inputs(self, batch: int
                       ) -> Optional[tuple[tuple[int, ...], torch.dtype]]:
        """The stub context's (shape, dtype): whisper's frame embeddings
        ``[B, encoder_seq, D]`` or the vision patch embeddings ``[B,
        image_tokens, D]``, bf16; ``None`` for a family without one."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return (batch, cfg.encdec.encoder_seq, cfg.d_model), \
                torch.bfloat16
        if cfg.family == "vlm":
            return (batch, cfg.vlm.image_tokens, cfg.d_model), torch.bfloat16
        return None

    def _context(self, params: PyTree, context):
        """encdec runs its encoder over the stub embeddings; vlm reads the
        patch embeddings as they are."""
        if context is None or self.cfg.family != "encdec":
            return context
        return T.encode(params, self.cfg, context)

    # -- training ------------------------------------------------------------

    def forward(self, params: PyTree, tokens: torch.Tensor, *,
                context: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens [*rank, B, T] -> (hidden [*rank, B, T, D], aux_loss
        [*rank]); ``context`` [*rank, B, Tc, D] for encdec and vlm."""
        return T.forward(params, self.cfg, tokens,
                         context=self._context(params, context))

    def logits(self, params: PyTree, hidden: torch.Tensor) -> torch.Tensor:
        return T.logits(params, self.cfg, hidden)

    # -- serving -------------------------------------------------------------

    def init_cache(self, batch: int, seq: int, dtype=torch.bfloat16,
                   device=None) -> PyTree:
        return D.init_cache(self.cfg, batch, seq, dtype,
                            device=_device(device))

    @torch.no_grad()
    def prefill(self, params: PyTree, tokens: torch.Tensor, cache: PyTree,
                *, context: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, PyTree]:
        return D.prefill(params, self.cfg, tokens, cache,
                         context=self._context(params, context),
                         use_kernels=self.use_kernels)

    @torch.no_grad()
    def decode_step(self, params: PyTree, token: torch.Tensor,
                    cache: PyTree, index, *,
                    context: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, PyTree]:
        return D.decode_step(params, self.cfg, token, cache, index,
                             context=self._context(params, context),
                             use_kernels=self.use_kernels)
