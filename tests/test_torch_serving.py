"""The port's continuous-batching ``ServeEngine`` against the reference's,
on the rwkv6 and recurrentgemma smoke configs with the reference's seeded
params.

* No slot reused (slots >= requests, all admitted at the first tick):
  identical greedy completions, heterogeneous prompt and generation
  lengths included, and the same ``serve.*`` counters.
* ``SLOPolicy.decide``: the same verdict as the reference's for the same
  request, stubbed tick time and prefill count.
* Slot reuse (ROADMAP.md R3): the reference resets a cache leaf only where
  its dim 0 equals the slot count, but the stacked layer caches are
  ``[n_layers, slots, ...]``.  With 2 or 3 slots and one request more, the
  reference's completion in the reused slot differs from a fresh engine's;
  the port's equals the fresh engine's (and that one equals the
  reference's fresh engine).
* recurrentgemma (the hybrid family: RG-LRU state, conv windows and
  window-attention rings) with f32-cast params: the same completions
  without slot reuse, a ring wrap in the engine included, and the
  slot-reuse repair; every hybrid cache leaf of an admitted slot reset
  (ring ``pos`` to -1, the rest to 0); the engine's caches in the
  reference's dtypes, leaf by leaf (bf16 rings, ROADMAP.md F1), and one
  more decode step from the two engines' caches within 2^-14.  In bf16
  a random-weight model's top-2 logit gaps are of the size of the two
  frameworks' roundings, so greedy tokens there would compare rounding,
  not the engine (``test_torch_models.py`` holds the bf16 logits).
"""

import dataclasses

import time

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.obs import metrics as jobs
from repro.serve import engine as J
from repro_torch import configs, interop, tree
from repro_torch.models import Model
from repro_torch.obs import metrics as tobs
from repro_torch.serve import engine as P

ARCH = "rwkv6-1.6b"


@pytest.fixture(scope="module")
def served():
    jm = JModel(jconfigs.get_smoke(ARCH))
    jp = jm.init(jax.random.key(0))
    return jm, jp, Model(configs.get_smoke(ARCH)), \
        interop.params_from_reference(jp)


def _run(mod, model, params, reqs, slots, recorder=None):
    eng = mod.ServeEngine(model, params, slots=slots, max_seq=64,
                          recorder=recorder)
    for rid, prompt, n_new in reqs:
        eng.submit(mod.Request(rid=rid, prompt=prompt, max_new_tokens=n_new))
    done = eng.run_to_completion()
    assert [c.rid for c in done] == [r[0] for r in reqs]
    return [c.tokens for c in done], eng


def _requests(rng, shapes):
    return [(i, rng.integers(0, 512, n).astype(np.int32), g)
            for i, (n, g) in enumerate(shapes)]


@pytest.mark.parametrize("slots,shapes", [
    (3, [(5, 6), (3, 8), (7, 4)]),
    (4, [(2, 9), (6, 3), (4, 5)]),
    (5, [(1, 4), (9, 7), (3, 3), (6, 10), (2, 2)]),
])
def test_completions_equal_the_reference_without_slot_reuse(
        served, rng, slots, shapes):
    jm, jp, model, tp = served
    reqs = _requests(rng, shapes)
    jrec, trec = jobs.Recorder(), tobs.Recorder()
    want, jeng = _run(J, jm, jp, reqs, slots, jrec)
    got, teng = _run(P, model, tp, reqs, slots, trec)
    assert got == want
    assert [len(t) for t in got] == [g for _, g in shapes]
    assert teng.ticks == jeng.ticks
    for name in ("serve.ticks", "serve.admitted", "serve.retired",
                 "serve.host_sync"):
        assert trec.counter(name) == jrec.counter(name), name


@pytest.mark.parametrize("slots", [2, 3])
def test_reused_slot_starts_from_a_zero_state(served, rng, slots):
    """One request more than slots: the last request lands in a reused
    slot.  The reference's completion there differs from a fresh
    engine's (its state and token shifts carry over, R3); the port's
    equals a fresh engine's."""
    jm, jp, model, tp = served
    reqs = _requests(rng, [(5, 6)] * (slots + 1))
    alone = [(0,) + reqs[-1][1:]]
    fresh_ref, _ = _run(J, jm, jp, alone, 1)
    fresh_port, _ = _run(P, model, tp, alone, 1)
    assert fresh_port == fresh_ref
    ref_all, _ = _run(J, jm, jp, reqs, slots)
    port_all, _ = _run(P, model, tp, reqs, slots)
    assert ref_all[-1] != fresh_ref[0]            # the reference's fault
    assert port_all[-1] == fresh_port[0]          # the port's repair
    assert port_all[:slots] == ref_all[:slots]    # first-use slots agree


def test_continuous_batching_matches_fresh_single_request_engines(served,
                                                                  rng):
    """More requests than slots, heterogeneous lengths: every completion
    equals its own fresh single-slot engine's."""
    _, _, model, tp = served
    reqs = _requests(rng, [(3, 8), (7, 4), (5, 6), (2, 9), (4, 5)])
    got, eng = _run(P, model, tp, reqs, 2)
    for (rid, prompt, n_new), tokens in zip(reqs, got):
        alone, _ = _run(P, model, tp, [(0, prompt, n_new)], 1)
        assert tokens == alone[0], f"rid {rid}"
    assert eng.ticks < sum(len(p) + g for _, p, g in reqs)


class _StubEngine:
    def __init__(self, tick, slots=4):
        self._tick = tick
        self.slots = slots
        self.collectives = None

    def tick_time_estimate(self):
        return self._tick


@pytest.mark.parametrize("tick", [None, 0.001, 0.01, 0.1])
def test_slo_policy_decides_like_the_reference(tick):
    cases = []
    for deadline in (None, 0.05, 0.5, 5.0):
        for prompt_len in (1, 8, 40):
            for n_new in (1, 16):
                for cap in (None, 1, 3):
                    for n_pref in (0, 1, 3):
                        cases.append((deadline, prompt_len, n_new, cap,
                                      n_pref))
    for deadline, prompt_len, n_new, cap, n_pref in cases:
        verdicts = []
        for mod in (J, P):
            req = mod.Request(rid=0, prompt=np.zeros(prompt_len, np.int32),
                              max_new_tokens=n_new, deadline_s=deadline)
            req.t_submit = time.monotonic()
            pol = mod.SLOPolicy(max_concurrent_prefills=cap, slack=1.5)
            verdicts.append(pol.decide(req, _StubEngine(tick), n_pref))
        assert verdicts[0] == verdicts[1], (deadline, prompt_len, n_new,
                                            cap, n_pref)


def test_slo_policy_rejects_expired_and_membership_inflates():
    class Members:
        n_ranks, n_alive = 4, 2
    for mod in (J, P):
        req = mod.Request(rid=0, prompt=np.zeros(10, np.int32),
                          max_new_tokens=10, deadline_s=1.0)
        req.t_submit = time.monotonic()
        # 20 ticks of 0.04 s fit 1 s; on half the fabric they do not
        assert mod.SLOPolicy().decide(req, _StubEngine(0.04), 0) == "admit"
        assert mod.SLOPolicy(membership=Members()).decide(
            req, _StubEngine(0.04), 0) == "reject"
        req.t_submit -= 2.0
        assert mod.SLOPolicy().decide(req, _StubEngine(None), 0) == "reject"


def test_engine_with_slo_admission_rejects_what_cannot_finish(served, rng):
    _, _, model, tp = served
    eng = P.ServeEngine(model, tp, slots=2, max_seq=64,
                        admission=P.SLOPolicy(max_concurrent_prefills=1))
    rec = tobs.Recorder()
    eng.recorder = rec
    eng.submit(P.Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                         max_new_tokens=3))
    eng.submit(P.Request(rid=1, prompt=np.arange(4, dtype=np.int32),
                         max_new_tokens=3, deadline_s=0.0))
    eng.submit(P.Request(rid=2, prompt=np.arange(3, dtype=np.int32),
                         max_new_tokens=2))
    done = eng.run_to_completion()
    assert [c.rid for c in done] == [0, 2]
    assert [r.rid for r in eng.rejected] == [1]
    assert rec.counter("serve.slo_rejected") == 1
    assert rec.counter("serve.admit_deferred") >= 1


def test_engine_rejects_what_the_port_does_not_run(served):
    _, _, model, tp = served
    # tensor-parallel serving takes the dense and moe families only
    from repro_torch.serve.collectives import ServeCollectives
    with pytest.raises(NotImplementedError, match="dense/moe"):
        P.ServeEngine(model, tp, slots=2, collectives=ServeCollectives(
            model.cfg, 2, device="cpu"))
    eng = P.ServeEngine(model, tp, slots=2, max_seq=16)
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(P.Request(rid=0, prompt=np.zeros(10, np.int32),
                             max_new_tokens=6))
    assert eng.cache["layers"]["pos0_rwkv"]["s"].device == \
        torch.device("cpu")


# ---------------------------------------------------------------------------
# the hybrid family
# ---------------------------------------------------------------------------

HYB = "recurrentgemma-9b"


@pytest.fixture(scope="module")
def served_hybrid():
    jm = JModel(jconfigs.get_smoke(HYB))
    jp = jax.tree.map(lambda p: p.astype(jax.numpy.float32)
                      if p.dtype == jax.numpy.bfloat16 else p,
                      jm.init(jax.random.key(0)))
    return jm, jp, Model(configs.get_smoke(HYB)), \
        interop.params_from_reference(jp)


@pytest.mark.parametrize("slots,shapes", [
    (3, [(5, 6), (3, 8), (7, 4)]),
    (5, [(1, 4), (9, 7), (3, 3), (17, 10), (2, 2)]),
    (2, [(30, 12), (12, 20)]),              # past the 16-token window
])
def test_hybrid_completions_equal_the_reference_without_slot_reuse(
        served_hybrid, rng, slots, shapes):
    jm, jp, model, tp = served_hybrid
    reqs = _requests(rng, shapes)
    jrec, trec = jobs.Recorder(), tobs.Recorder()
    want, jeng = _run(J, jm, jp, reqs, slots, jrec)
    got, teng = _run(P, model, tp, reqs, slots, trec)
    assert got == want
    assert teng.ticks == jeng.ticks
    for name in ("serve.ticks", "serve.admitted", "serve.retired"):
        assert trec.counter(name) == jrec.counter(name), name


@pytest.mark.parametrize("slots", [2, 3])
def test_hybrid_reused_slot_starts_from_a_zero_state(served_hybrid, rng,
                                                     slots):
    """The reference's fresh run is a two-slot engine serving the request
    alone: with one slot and one layer period its reset would hit the
    stacked caches' period dim and fill the ring's ``pos`` with 0 (R3)."""
    jm, jp, model, tp = served_hybrid
    reqs = _requests(rng, [(5, 6)] * (slots + 1))
    alone = [(0,) + reqs[-1][1:]]
    fresh_ref, _ = _run(J, jm, jp, alone, 2)
    fresh_port, _ = _run(P, model, tp, alone, 1)
    assert fresh_port == fresh_ref
    ref_all, _ = _run(J, jm, jp, reqs, slots)
    port_all, _ = _run(P, model, tp, reqs, slots)
    assert ref_all[-1] != fresh_ref[0]            # the reference's fault
    assert port_all[-1] == fresh_port[0]          # the port's repair
    assert port_all[:slots] == ref_all[:slots]    # first-use slots agree


def _leaves(cache, prefix=""):
    """``{path: leaf}`` of a nested cache dict (reference or port)."""
    if isinstance(cache, dict):
        out = {}
        for k in sorted(cache):
            out.update(_leaves(cache[k], f"{prefix}/{k}"))
        return out
    return {prefix: cache}


def test_hybrid_engine_caches_follow_the_reference_dtypes(served_hybrid,
                                                          rng):
    """F1 (ROADMAP.md §3): on f32 params the engine's caches start in bf16,
    as the reference's ``init_cache(slots, max_seq)`` does (the RG-LRU
    state ``h`` is f32 in both), and keep the reference's dtypes leaf by
    leaf after serving: rings stay bf16, conv windows take the f32
    activations.  One decode step from the two engines' final caches
    gives logits within 2^-14 of the largest |logit|; with f32 rings the
    gap is some 20 times that."""
    jm, jp, model, tp = served_hybrid
    jeng = J.ServeEngine(jm, jp, slots=3, max_seq=64)
    teng = P.ServeEngine(model, tp, slots=3, max_seq=64)
    for leaves in (_leaves(jeng.cache), _leaves(teng.cache)):
        for path, leaf in leaves.items():
            kind = path.rsplit("/", 1)[-1]
            want = {"h": "float32", "pos": "int32"}.get(kind, "bfloat16")
            assert str(leaf.dtype).removeprefix("torch.") == want, path
    reqs = _requests(rng, [(5, 6), (3, 8), (17, 10)])
    want, jeng = _run(J, jm, jp, reqs, 3)
    got, teng = _run(P, model, tp, reqs, 3)
    assert got == want
    jl, tl = _leaves(jeng.cache), _leaves(teng.cache)
    assert sorted(jl) == sorted(tl)
    for path in jl:
        assert str(tl[path].dtype).removeprefix("torch.") \
            == str(jl[path].dtype), path
    for path in ("/layers/pos2_window/k", "/layers/pos2_window/v"):
        assert tl[path].dtype == torch.bfloat16, path
    tok = np.array([7, 100, 300], np.int32)
    idx = np.minimum(teng.pos, 63).astype(np.int32)
    ref, _ = jm.decode_step(jp, jax.numpy.asarray(tok), jeng.cache,
                            jax.numpy.asarray(idx))
    port, _ = model.decode_step(tp, torch.from_numpy(tok), teng.cache,
                                torch.from_numpy(idx))
    ref = np.asarray(ref, np.float32)
    gap = np.abs(port.numpy() - ref).max()
    assert gap <= 2.0 ** -14 * np.abs(ref).max(), gap


def test_hybrid_slot_reset_clears_every_cache_kind():
    """A stack whose period and remainder both hold window layers: the
    admitted slot's row of every leaf is reset — ``pos`` to -1 in the
    stacked ``[n_periods, slots, W]`` and the remainder's ``[slots, W]``,
    k, v, h and the conv window to 0 — and the other slots keep theirs."""
    base = configs.get_smoke(HYB)
    cfg = dataclasses.replace(base, n_layers=5, hybrid=dataclasses.replace(
        base.hybrid, pattern=("attn", "lru")))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = P.ServeEngine(model, params, slots=3, max_seq=20)
    assert sorted(eng.cache["rem"]) == ["rem0_window"]
    for leaf in tree.tree_leaves(eng.cache):
        leaf.fill_(5)
    eng._reset_slot_caches([1])
    for part, dim in (("layers", 1), ("rem", 0)):
        for name, c in eng.cache[part].items():
            for key, leaf in c.items():
                row = leaf.select(dim, 1)
                want = -1 if key == "pos" else 0
                assert bool((row == want).all()), (part, name, key)
                for other in (0, 2):
                    assert bool((leaf.select(dim, other) == 5).all())



# ---------------------------------------------------------------------------
# the dense family (acis-100m), plain and tensor-parallel transports
# ---------------------------------------------------------------------------

DENSE = "acis-100m"


@pytest.fixture(scope="module")
def served_dense():
    """f32-cast params: greedy tokens then compare the engines, not the
    two frameworks' bf16 roundings at a random model's near-ties."""
    jm = JModel(jconfigs.get_smoke(DENSE))
    jp = jax.tree.map(lambda p: p.astype(jax.numpy.float32)
                      if p.dtype == jax.numpy.bfloat16 else p,
                      jm.init(jax.random.key(0)))
    return jm, jp, Model(configs.get_smoke(DENSE)), \
        interop.params_from_reference(jp)


def _dense_requests(rng, shapes):
    return [(i, rng.integers(0, 256, n).astype(np.int32), g)
            for i, (n, g) in enumerate(shapes)]


@pytest.mark.parametrize("slots,shapes", [
    (3, [(5, 6), (3, 8), (7, 4)]),
    (2, [(4, 5), (6, 3), (3, 6)]),          # the third reuses a slot
])
def test_dense_completions_equal_the_reference(served_dense, rng, slots,
                                               shapes):
    """The KV cache past a row's position is masked, so a reused slot's
    stale keys change nothing in either engine."""
    jm, jp, model, tp = served_dense
    reqs = _dense_requests(rng, shapes)
    jrec, trec = jobs.Recorder(), tobs.Recorder()
    want, jeng = _run(J, jm, jp, reqs, slots, jrec)
    got, teng = _run(P, model, tp, reqs, slots, trec)
    assert got == want
    assert teng.ticks == jeng.ticks
    for name in ("serve.ticks", "serve.admitted", "serve.retired",
                 "serve.host_sync"):
        assert trec.counter(name) == jrec.counter(name), name


def test_dense_tp_engine_equals_the_reference_tp_engine(served_dense, rng):
    """``ServeEngine(collectives=ServeCollectives(cfg, 2))`` in both
    packages: the same completions and ticks."""
    from repro.serve.collectives import ServeCollectives as JSC
    from repro.serve.collectives import SwitchProgramCache as JCache
    from repro_torch.serve.collectives import (ServeCollectives,
                                               SwitchProgramCache)
    jm, jp, model, tp = served_dense
    reqs = _dense_requests(rng, [(5, 4), (3, 6), (6, 3)])

    def run(mod, m, p, sc):
        eng = mod.ServeEngine(m, p, slots=2, max_seq=48, collectives=sc)
        for rid, prompt, n_new in reqs:
            eng.submit(mod.Request(rid=rid, prompt=prompt,
                                   max_new_tokens=n_new))
        return [c.tokens for c in eng.run_to_completion()], eng.ticks

    want = run(J, jm, jp, JSC(jm.cfg, 2, cache=JCache()))
    got = run(P, model, tp, ServeCollectives(model.cfg, 2, device="cpu",
                                             cache=SwitchProgramCache()))
    assert got == want
