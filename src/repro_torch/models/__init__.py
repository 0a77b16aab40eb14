"""Models: the port's counterpart of :mod:`repro.models`.

Ported so far, on their serving paths (``Model.init`` / ``init_cache`` /
``prefill`` / ``decode_step``): the ``dense`` family and the ``moe``
family with GQA attention (``moe``, ``parallel``: the tensor-parallel
hook that :mod:`repro_torch.serve.collectives` drives), the ``ssm``
family (RWKV-6), with the ``rwkv6_recurrence`` kernel computing every WKV
step, and the ``hybrid`` family (RG-LRU + sliding-window attention,
recurrentgemma), with the ``rglru_scan`` kernel computing every RG-LRU
recurrence.  MLA attention (deepseek-v2), the encdec and vlm families
and training wait in ROADMAP.md (queue 1 items 6-7).
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model

__all__ = ["Model", "ModelConfig"]
