"""repro_torch.serve — the continuous-batching serving engine.

``engine`` is the host-side control loop (slots, admission, SLO policy)
over ``Model.decode_step``.  The compiled tensor-parallel data path
(``repro.serve.collectives``) waits for ROADMAP.md queue 1 item 8.
"""

from repro_torch.serve.engine import Completion, Request, ServeEngine, \
    SLOPolicy

__all__ = ["Completion", "Request", "SLOPolicy", "ServeEngine"]
