"""Models: the port's counterpart of :mod:`repro.models`.

Every family of the reference's zoo, on its serving paths
(``Model.init`` / ``init_cache`` / ``prefill`` / ``decode_step``) and its
training forward (``Model.forward``): ``dense``, ``moe`` with GQA or MLA
attention (``moe``, ``mla``; ``parallel``: the tensor-parallel hook that
:mod:`repro_torch.serve.collectives` drives), ``ssm`` (RWKV-6, the
``rwkv6_recurrence`` kernel computing every serving WKV step),
``hybrid`` (RG-LRU + sliding-window attention, the ``rglru_scan`` kernel
computing every serving RG-LRU recurrence), ``encdec`` (whisper: an
encoder and cross attention) and ``vlm`` (llama vision: gated image
cross-attention layers).
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model

__all__ = ["Model", "ModelConfig"]
