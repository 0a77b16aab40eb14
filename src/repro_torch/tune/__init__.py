"""repro_torch.tune — profile-guided plan autotuning (the PyTorch
counterpart of :mod:`repro.tune`, framework-free).

The ACiS software stack closes its loop by *observing* the deployed
program and refining the plan from measurements rather than from the
analytic model alone (§V: evaluate → map → refine).  This package is
that loop for the repro:

  1. **record** (:mod:`repro_torch.tune.trace`) — per-stage wall-clock traces
     from the dataplane simulator, from the executor's instrumented
     mode (CUDA events on the card), or from interleaved prefix timing;
     JSONL on disk, schema-versioned.
  2. **fit** (:mod:`repro_torch.tune.fit`) — least-squares
     :class:`~repro_torch.core.netmodel.NetParams` from traces: per-tier
     latency/bandwidth, the host-fallback detour, and the per-tier
     overlap fractions (``fit_tier_overlap`` as one special case).
  3. **replay** (:mod:`repro_torch.tune.replay`) — score a *candidate* plan
     against a recording: measured times where stages match, fitted
     model times where they don't.
  4. **search** (:mod:`repro_torch.tune.search`) — coordinate descent over
     the tunable config fields with replay as the objective; winners
     persist to ``.acis_tune_torch.json`` and are applied transparently by
     ``engine.compile`` / ``gradient_sync`` when
     ``CollectiveConfig(autotune=True)``.
"""

from repro_torch.tune.fit import (NetFit, TunedTopology, fit_net_params,
                            fit_overlap, fit_traces)
from repro_torch.tune.replay import ReplayResult, StageScore, replay
from repro_torch.tune.search import (DEFAULT_SPACE, SearchResult, TuneDB,
                               plan_key, search, tuned_config)
from repro_torch.tune.trace import (SCHEMA_VERSION, ProgramTrace, StageTrace,
                              from_sim, interleaved_medians, load_jsonl,
                              record_instrumented, record_sim,
                              record_stagewise, save_jsonl)

__all__ = [
    "SCHEMA_VERSION", "StageTrace", "ProgramTrace", "from_sim",
    "record_sim", "record_instrumented", "record_stagewise",
    "interleaved_medians", "save_jsonl", "load_jsonl",
    "NetFit", "TunedTopology", "fit_net_params", "fit_overlap",
    "fit_traces",
    "ReplayResult", "StageScore", "replay",
    "DEFAULT_SPACE", "SearchResult", "TuneDB", "plan_key", "search",
    "tuned_config",
]
