"""repro_torch.elastic — elastic, fault-tolerant sync as a runtime citizen.

Three pieces (see ROADMAP "Elastic, fault-tolerant sync"):

  * :class:`Membership` — the alive-mask view, with deadline verdicts
    fed from measured per-rank spans (``obs`` / ``SwitchSim`` reports).
  * :func:`sync_with_deadline` — retry/backoff control loop around the
    compiled masked collective (``gradient_sync(membership=...)``).
  * :class:`TopologyDelta` — what changed, and whether
    ``engine.recompile`` may reuse the cached program + arenas
    (shape-preserving) or must compile fresh (shapes moved).

The compiled mechanism itself lives in the compiler
(:func:`repro_torch.core.tracing.masked_reduce`) — the mask is a runtime
program input, so membership changes never retrace.
"""

from repro_torch.elastic.membership import Membership, TopologyDelta
from repro_torch.elastic.sync import (ElasticSyncError, SyncOutcome,
                                deadline_verdicts, sync_with_deadline)

__all__ = [
    "Membership", "TopologyDelta", "ElasticSyncError", "SyncOutcome",
    "deadline_verdicts", "sync_with_deadline",
]
