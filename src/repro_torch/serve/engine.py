"""Batched serving engine: continuous batching with per-slot positions.

The port of :mod:`repro.serve.engine`.  Fixed B decode slots; every slot
carries its own position.  Finished sequences are immediately replaced
from the request queue; new prompts prefill *inside the running batch*:
the new slot steps through its prompt tokens while other slots keep
generating, one ``Model.decode_step`` per tick for everything.

Transport: plain — ``model.decode_step`` eagerly on the params'
device, the cache updated in place (the reference donates it to its
jitted step) — or, with ``collectives=`` a
:class:`repro_torch.serve.collectives.ServeCollectives`, tensor-parallel:
the engine splits the params and its cache once over the ``tp`` mesh and
calls ``collectives.decode_fn`` every tick (every layer's all-reduces,
and a MoE stack's all-to-alls, are compiled switch programs).

Admission is SLO-aware when an :class:`SLOPolicy` is installed, as in
the reference: requests carry deadlines, the cost of admitting is
estimated from measured tick times (before any tick, from the compiled
decode programs' cost-model time), and requests that cannot make their
deadline are rejected at admission.

One repair against the reference: an admitted slot's cache rows are
reset along the slot dim of each leaf — dim 1 of the stacked
``cache["layers"]`` leaves, dim 0 of ``cache["rem"]`` (one further in
for the rank dim of a tensor-parallel cache).  The reference
resets a leaf only where its dim 0 equals the slot count, so a request
admitted into a reused slot inherits the previous request's RWKV state
and token shifts (or, when the layer count equals the slot count, a
whole layer is zeroed instead of a slot); ROADMAP.md R3.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.models.model import Model
from repro_torch.obs import metrics as _obs

PyTree = Any


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [t] int32
    max_new_tokens: int = 16
    eos: Optional[int] = None
    # SLO deadline in seconds from submit to last token; None = best-effort
    deadline_s: Optional[float] = None
    # stamped by ServeEngine.submit (time.monotonic)
    t_submit: float = dataclasses.field(default=0.0, compare=False)


@dataclasses.dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: list[int]


@dataclasses.dataclass
class SLOPolicy:
    """Admission policy for deadline-carrying requests.

    ``decide`` returns one of

      * ``"admit"``  — take the request into the free slot
      * ``"reject"`` — it cannot make its deadline even if admitted now;
        drop it at admission (``serve.slo_rejected``)
      * ``"defer"``  — leave it queued this tick
        (``serve.admit_deferred``): too many slots are already
        prefilling

    The per-tick cost estimate is the engine's
    :meth:`ServeEngine.tick_time_estimate`; with none (plain transport,
    nothing measured yet) only expired deadlines reject.  Deadline checks
    run before the prefill-cap defer.  In-batch prefill pays one tick per
    prompt token; on the compiled transport the time to the first token
    is at least the batched prefill's cost-model switch time
    (``prefill_comm_time``), as in the reference.  ``membership`` (any
    object with ``n_ranks`` and ``n_alive``) inflates the estimate by
    ``n_ranks / n_alive``.
    """

    # admit at most this many concurrently-prefilling slots (None = no cap)
    max_concurrent_prefills: Optional[int] = None
    # safety factor on the completion-time estimate (>1 rejects earlier)
    slack: float = 1.0
    # elastic membership view; masked ranks inflate the tick estimate
    membership: Optional[Any] = None

    def _degrade_factor(self) -> float:
        m = self.membership
        if m is None:
            return 1.0
        n = getattr(m, "n_ranks", 0)
        a = getattr(m, "n_alive", n)
        if not n:
            return 1.0
        return float("inf") if a == 0 else n / a

    def decide(self, req: Request, engine: "ServeEngine",
               n_prefilling: int) -> str:
        if req.deadline_s is not None:
            waited = time.monotonic() - req.t_submit
            if waited >= req.deadline_s:
                return "reject"       # expired while queued/deferred
            tick = engine.tick_time_estimate()
            if tick is not None:
                tick = tick * self._degrade_factor()
                # in-batch prefill pays one tick per prompt token
                ttft = len(req.prompt) * tick
                sc = getattr(engine, "collectives", None)
                if sc is not None:
                    ttft = max(ttft, sc.prefill_comm_time(
                        engine.slots, max(len(req.prompt), 1)))
                est = waited + ttft + req.max_new_tokens * tick
                if est * self.slack > req.deadline_s:
                    return "reject"
        if self.max_concurrent_prefills is not None \
                and n_prefilling >= self.max_concurrent_prefills:
            return "defer"
        return "admit"


class ServeEngine:
    def __init__(self, model: Model, params: PyTree, *, slots: int = 4,
                 max_seq: int = 256, recorder: Optional[_obs.Recorder] = None,
                 collectives=None, admission: Optional[SLOPolicy] = None):
        self.model = model
        self.collectives = collectives
        # per-engine recorder; defaults to the process-wide one at call
        # time (so ``obs.recording()`` around a serving loop just works)
        self.recorder = recorder
        self.slots = slots
        self.max_seq = max_seq
        self.admission = admission
        # the cache lives with the params, in bf16 whatever their dtype
        # (the reference's ``model.init_cache(slots, max_seq)``)
        self.device = params["embed"].device
        cache = model.init_cache(slots, max_seq, device=self.device)
        if collectives is None:
            self.params, self.cache = params, cache
            self._rank_ndim = 0
            self._decode = model.decode_step
        else:
            # split once; the cache leaves carry the rank dim after the
            # layer dim (ServeCollectives.shard_cache)
            self.params = collectives.shard_params(params)
            self.cache = collectives.shard_cache(cache)
            del cache
            self._rank_ndim = 1
            self._decode = collectives.decode_fn(self.params, self.cache)

        # host-side slot state
        self.rid = np.full(slots, -1, np.int64)
        self.pos = np.zeros(slots, np.int32)          # next write position
        self.remaining = np.zeros(slots, np.int32)
        self.eos = np.full(slots, -1, np.int64)
        self.prompt: list[Optional[np.ndarray]] = [None] * slots
        self.prompt_cursor = np.zeros(slots, np.int32)
        self.deadline = np.full(slots, np.inf)
        self.t_submit = np.zeros(slots)
        self.generated: list[list[int]] = [[] for _ in range(slots)]
        self.queue: collections.deque[Request] = collections.deque()
        self.done: list[Completion] = []
        self.rejected: list[Request] = []
        self.ticks = 0
        # per-tick wall times (the tick's one host sync makes every tick
        # a natural timing boundary) -> p50/p99 gauges + admission
        self._tick_times: collections.deque[float] = collections.deque(
            maxlen=256)

    def submit(self, req: Request):
        if len(req.prompt) + req.max_new_tokens >= self.max_seq:
            raise ValueError(f"request {req.rid}: prompt {len(req.prompt)} "
                             f"+ {req.max_new_tokens} new tokens does not "
                             f"fit max_seq {self.max_seq}")
        req.t_submit = time.monotonic()
        self.queue.append(req)

    def tick_time_estimate(self) -> Optional[float]:
        """Seconds per engine tick: the measured p50 once ticks have run,
        else the compiled decode programs' cost-model switch time
        (``decode_comm_time``), else None (plain transport, nothing
        measured yet)."""
        if self._tick_times:
            return float(np.median(self._tick_times))
        if self.collectives is not None:
            return self.collectives.decode_comm_time(self.slots)
        return None

    # -- slot management -------------------------------------------------------

    def _reset_slot_caches(self, slot_ids: list[int]):
        """Reset the cache rows of every slot admitted this tick, along
        each leaf's slot dim: dim 1 of the stacked layer caches
        ``[n_periods, slots, ...]``, dim 0 of the remainder caches, one
        further in on a tensor-parallel cache (its rank dim).  Window
        ``pos`` buffers (int32, ``[slots, W]`` per layer) take -1 =
        invalid, everything else 0 (RWKV state and shifts, RG-LRU state
        and conv windows, ring and full KV caches)."""
        idx = torch.as_tensor(slot_ids, dtype=torch.int64,
                              device=self.device)
        r = self._rank_ndim
        for part, dim in (("layers", 1 + r), ("rem", r)):
            for leaf in tree.tree_leaves(self.cache[part]):
                fill = -1 if leaf.dtype == torch.int32 \
                    and leaf.dim() == dim + 2 else 0
                leaf.index_fill_(dim, idx, fill)

    def _admit(self, s: int, req: Request):
        """Host-side slot bookkeeping; the cache rows are cleared by the
        caller's batched :meth:`_reset_slot_caches`."""
        self.rid[s] = req.rid
        self.pos[s] = 0
        self.remaining[s] = req.max_new_tokens
        self.eos[s] = -1 if req.eos is None else req.eos
        self.prompt[s] = np.asarray(req.prompt, np.int32)
        self.prompt_cursor[s] = 0
        self.deadline[s] = np.inf if req.deadline_s is None else req.deadline_s
        self.t_submit[s] = req.t_submit
        self.generated[s] = []

    def _retire(self, s: int):
        self.done.append(Completion(int(self.rid[s]),
                                    len(self.prompt[s]),
                                    self.generated[s]))
        self.rid[s] = -1

    # -- one engine tick ---------------------------------------------------------

    def step(self) -> int:
        rec = self.recorder if self.recorder is not None else _obs.RECORDER
        rec.count("serve.ticks")
        rec.gauge("serve.queue_depth", len(self.queue))
        admitted_slots: list[int] = []
        n_prefilling = sum(
            1 for s in range(self.slots)
            if self.rid[s] >= 0
            and self.prompt_cursor[s] < len(self.prompt[s]))
        deferred = False
        for s in range(self.slots):
            if self.rid[s] >= 0 or deferred:
                continue
            while self.queue:
                req = self.queue[0]
                verdict = "admit" if self.admission is None else \
                    self.admission.decide(req, self, n_prefilling)
                if verdict == "reject":
                    self.queue.popleft()
                    self.rejected.append(req)
                    rec.count("serve.slo_rejected")
                    continue
                if verdict == "defer":
                    rec.count("serve.admit_deferred")
                    deferred = True
                    break
                self.queue.popleft()
                self._admit(s, req)
                admitted_slots.append(s)
                n_prefilling += 1
                break
        if admitted_slots:
            self._reset_slot_caches(admitted_slots)
            rec.count("serve.admitted", len(admitted_slots))
        active = np.flatnonzero(self.rid >= 0)
        rec.gauge("serve.active", int(active.size))
        if active.size == 0:
            return 0

        # token each active slot feeds this tick: next prompt token while
        # prefilling, else its last generated token
        tok = np.zeros(self.slots, np.int32)
        in_prefill = np.zeros(self.slots, bool)
        for s in active:
            cur = self.prompt_cursor[s]
            if cur < len(self.prompt[s]):
                tok[s] = self.prompt[s][cur]
                in_prefill[s] = True
            else:
                tok[s] = self.generated[s][-1] if self.generated[s] \
                    else self.prompt[s][-1]

        t0 = time.perf_counter()
        lg, self.cache = self._decode(
            self.params, torch.from_numpy(tok).to(self.device), self.cache,
            torch.from_numpy(self.pos.copy()).to(self.device))
        # the tick's ONE host sync: greedy sampling needs the argmax on
        # the host (torch.argmax takes the first maximum, as np.argmax)
        nxt_all = lg.argmax(-1).cpu().numpy()
        dt = time.perf_counter() - t0
        self._tick_times.append(dt)
        if rec.enabled:
            rec.count("serve.host_sync")
            rec.observe("serve.decode_s", dt)
            order = sorted(self._tick_times)
            rec.gauge("serve.decode_p50_s", order[len(order) // 2])
            rec.gauge("serve.decode_p99_s",
                      order[min(len(order) - 1, int(len(order) * 0.99))])
            live = self.deadline[active]
            if np.isfinite(live).any():
                now = time.monotonic()
                headroom = (live - (now - self.t_submit[active]))
                rec.gauge("serve.deadline_headroom_s",
                          float(headroom[np.isfinite(live)].min()))
        self.ticks += 1

        retired = 0
        for s in active:
            self.pos[s] += 1
            if in_prefill[s]:
                self.prompt_cursor[s] += 1
                if self.prompt_cursor[s] < len(self.prompt[s]):
                    continue               # still prefilling
                # prompt finished: this tick's logits predict token 1
            nxt = int(nxt_all[s])
            self.generated[s].append(nxt)
            self.remaining[s] -= 1
            if (self.remaining[s] <= 0 or nxt == self.eos[s]
                    or self.pos[s] >= self.max_seq - 1):
                self._retire(s)
                retired += 1
        if retired:
            rec.count("serve.retired", retired)
        return int(active.size)

    def run_to_completion(self, max_ticks: int = 100000) -> list[Completion]:
        for _ in range(max_ticks):
            if self.step() == 0 and not self.queue:
                break
        return sorted(self.done, key=lambda c: c.rid)
