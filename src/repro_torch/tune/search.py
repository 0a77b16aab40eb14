"""Plan-space search + the on-disk tuning DB.

The closed loop: given a recorded trace (and optionally a fitted
:class:`~repro_torch.tune.fit.NetFit`), :func:`search` walks the tunable
:class:`~repro_torch.core.api.CollectiveConfig` fields — ``bucket_bytes`` ×
schedule crossover × ``overlap_dispatch`` × ``epilogue_hoist`` — by
coordinate descent, recompiling the program per candidate (pure-Python
pipeline) and scoring each plan with :func:`repro_torch.tune.replay.replay`
in microseconds.  Winners persist per (program structure, topology,
config family) in a JSON tuning DB, which ``engine.compile`` and
``gradient_sync`` consult when ``CollectiveConfig.autotune`` is on: a
DB hit applies the stored overrides without re-searching; a miss
searches once and stores.

DB location: ``CollectiveConfig.tune_db`` > ``$ACIS_TUNE_DB`` >
``./.acis_tune_torch.json`` (the reference's default is ``.acis_tune.json``;
the two never share winners).  Invalidation: entries key on a hash of the
program's leaf avals, topology (axis names/sizes/tiers) and the
non-tunable config fields, so any of those changing misses cleanly; a
file whose ``schema`` differs from :data:`DB_SCHEMA` is ignored
wholesale (stale winners are merely defaults, never errors).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Any, Callable, Optional

from repro_torch.tune.replay import replay as _replay

DB_SCHEMA = 1
# the port's own file: a plan tuned on the card must never be read back by
# the reference for the same plan key, nor the other way round
DEFAULT_DB_PATH = ".acis_tune_torch.json"
DB_ENV_VAR = "ACIS_TUNE_DB"

# the CollectiveConfig fields the tuner varies — exactly the fields the
# compiled-program cache keys must include (api.CollectiveConfig.cache_key)
TUNABLE_FIELDS = ("bucket_bytes", "latency_optimal_below",
                  "overlap_dispatch", "epilogue_hoist",
                  "use_kernels", "batch_rings", "batch_rings_bytes")

# candidate values per field; None in bucket_bytes = the netmodel-derived
# default, 0 = bucketing off.  Coordinate descent keeps evaluations at
# the sum, not the product, of these.
DEFAULT_SPACE = {
    "bucket_bytes": (None, 1 << 20, 2 << 20, 4 << 20, 8 << 20, 16 << 20, 0),
    "latency_optimal_below": (0, 16384, 1 << 17),
    "overlap_dispatch": (True, False),
    "epilogue_hoist": (True, False),
    # CUDA kernel bulk data path: fused pack+combine kernels on/off, and
    # merging a wave's same-axis rings into one batched launch.  The
    # bytes knob bounds which members merge: None = compiler default
    # per-member cap, 0 = merge everything regardless of size.
    "use_kernels": (False, True),
    "batch_rings": (False, True),
    "batch_rings_bytes": (None, 1 << 18, 0),
}

# incremented per executed search — how the tests assert a DB hit did
# NOT re-search
SEARCHES_RUN = 0


@dataclasses.dataclass(frozen=True)
class SearchResult:
    overrides: dict                # winning {field: value}
    score: float                   # replayed seconds of the winner
    default_score: float           # replayed seconds of the base config
    n_evals: int
    rows: tuple = ()               # ((overrides, score), …) every eval


def plan_key(name: str, in_avals, topo, cfg) -> str:
    """Stable DB key for one (program, topology, config family).

    Hashes the leaf avals, the topology (names/sizes/tiers) and the
    *non-tunable* config fields — two configs differing only in tuned
    fields share an entry (that is the point), anything else misses.
    """
    avals = tuple((tuple(a.shape), str(a.dtype)) for a in (in_avals or ()))
    axes = tuple((ax.name, ax.size, ax.tier)
                 for ax in getattr(topo, "axes", ()))
    fam = tuple(getattr(cfg, f, None)
                for f in ("backend", "codec", "compressor", "topk_ratio"))
    blob = repr((name, avals, axes, fam)).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


class TuneDB:
    """The on-disk winner store: ``{schema, entries: {key: entry}}``.

    Reads are mtime-cached; writes are read-modify-write through a
    same-directory temp file + atomic replace, so concurrent processes
    at worst lose a win, never corrupt the file.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get(DB_ENV_VAR, DEFAULT_DB_PATH)
        self._entries: Optional[dict] = None
        self._mtime: Optional[float] = None

    def _load(self) -> dict:
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            self._entries, self._mtime = {}, None
            return self._entries
        if self._entries is not None and mtime == self._mtime:
            return self._entries
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        if data.get("schema") != DB_SCHEMA:
            data = {}                  # foreign/stale DB: start clean
        self._entries = dict(data.get("entries", {}))
        self._mtime = mtime
        return self._entries

    def lookup(self, key: str) -> Optional[dict]:
        """The stored entry (``{"overrides": …, "score": …}``) or None."""
        return self._load().get(key)

    def store(self, key: str, overrides: dict, **meta) -> None:
        entries = dict(self._load())
        entries[key] = {"overrides": dict(overrides), **meta}
        payload = {"schema": DB_SCHEMA, "entries": entries}
        d = os.path.dirname(os.path.abspath(self.path))
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._entries, self._mtime = entries, None


def search(build: Callable[[Any], Any], *, base,
           trace=None, fit=None,
           space: Optional[dict] = None) -> SearchResult:
    """Coordinate-descent over the tunable config fields.

    ``build(config)`` compiles the program under a candidate config and
    returns the :class:`~repro_torch.core.compiler.CompiledProgram`; ``base``
    is the starting :class:`~repro_torch.core.api.CollectiveConfig`.  Each
    candidate plan is scored by replaying it against ``trace`` (under
    ``fit`` when given); with no trace the score is the pure analytic
    ``program_time`` — the offline-search mode ``autotune`` uses.
    Returns the winning overrides (only fields that differ from
    ``base``).
    """
    global SEARCHES_RUN
    SEARCHES_RUN += 1
    space = dict(DEFAULT_SPACE if space is None else space)
    cache: dict[tuple, float] = {}
    rows: list[tuple] = []

    def score_of(assign: dict) -> float:
        key = tuple(sorted(assign.items()))
        if key in cache:
            return cache[key]
        cfg = dataclasses.replace(base, **assign)
        compiled = build(cfg)
        r = _replay(
            compiled.plan, trace, compiled.topology, fit=fit,
            overlapped=assign.get("overlap_dispatch",
                                  getattr(base, "overlap_dispatch", True)))
        cache[key] = r.t_end
        rows.append((dict(assign), r.t_end))
        return r.t_end

    current = {f: getattr(base, f) for f in TUNABLE_FIELDS if f in space}
    default_score = score_of(current)
    best = default_score
    for field, values in space.items():
        if field not in current:
            continue
        for v in values:
            cand = {**current, field: v}
            s = score_of(cand)
            if s < best:
                best, current = s, cand
    overrides = {f: v for f, v in current.items()
                 if v != getattr(base, f)}
    return SearchResult(overrides=overrides, score=best,
                        default_score=default_score,
                        n_evals=len(cache), rows=tuple(rows))


def tuned_config(base, build: Callable[[Any], Any], *, key: str,
                 db: Optional[TuneDB] = None,
                 db_path: Optional[str] = None,
                 trace=None, fit=None, space: Optional[dict] = None):
    """The config ``engine.compile`` should actually use.

    DB hit → apply the stored overrides (no search); miss → run
    :func:`search` once, persist the winner, apply it.  Unknown override
    fields from a future build are dropped rather than crashing.
    """
    from repro_torch.obs import metrics as _obs

    db = db or TuneDB(db_path)
    entry = db.lookup(key)
    if entry is None:
        _obs.RECORDER.count("tune.db_search")
        res = search(build, base=base, trace=trace, fit=fit, space=space)
        db.store(key, res.overrides, score=res.score,
                 default_score=res.default_score, evals=res.n_evals)
        overrides = res.overrides
    else:
        _obs.RECORDER.count("tune.db_hit")
        overrides = entry.get("overrides", {})
    overrides = {f: v for f, v in overrides.items()
                 if f in TUNABLE_FIELDS and hasattr(base, f)}
    return dataclasses.replace(base, **overrides)
