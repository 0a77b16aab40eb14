"""Models: the port's counterpart of :mod:`repro.models`.

Ported so far: the ``ssm`` family (RWKV-6) on its serving path —
``Model.init`` / ``init_cache`` / ``prefill`` / ``decode_step`` — with the
``rwkv6_recurrence`` kernel computing every WKV step.  Other families and
training wait in ROADMAP.md (queue 1 items 6-7).
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model

__all__ = ["Model", "ModelConfig"]
