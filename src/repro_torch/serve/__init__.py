"""repro_torch.serve — the continuous-batching serving engine and the
compiled tensor-parallel data path.

``engine`` is the host-side control loop (slots, admission, SLO policy)
over ``Model.decode_step``; ``collectives`` (``ServeCollectives``) splits
a dense or MoE model over a ``tp`` mesh and runs its all-reduces and
all-to-alls as compiled switch programs (``ServeEngine(collectives=)``).
"""

from repro_torch.serve.collectives import (PROGRAM_CACHE, ServeCollectives,
                                           SwitchProgramCache)
from repro_torch.serve.engine import Completion, Request, ServeEngine, \
    SLOPolicy

__all__ = ["Completion", "PROGRAM_CACHE", "Request", "SLOPolicy",
           "ServeCollectives", "ServeEngine", "SwitchProgramCache"]
