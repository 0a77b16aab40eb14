"""The port's compiled serving data path against the reference's: TP
decode through ``engine.compile`` at TP=2 on ``LocalMesh({"tp": 2})``.

The port's counterparts of ``tests/test_serve_collectives.py``, on the
same fixtures (the acis-100m smoke config at ``jax.random.key(0)``, the
qwen2-moe smoke config at ``key(1)``), their params carried over by
``interop``.  Tolerances are the reference test's: dense TP decode within
3e-2 (absolute and relative) of the unsharded path, MoE within 5e-2 —
the TP path sums bf16 partials over the ranks — and the port's compiled
TP logits within the same of the reference's compiled TP logits.
Compiled against direct, and compiled with kernels against without,
are bitwise: the same rank-local math and the same ring fold.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.api import CollectiveConfig as JConfig
from repro.models import Model as JModel
from repro.serve import collectives as JSC
from repro.serve import engine as JE
from repro_torch import configs, interop, obs, tree
from repro_torch.core.api import CollectiveConfig
from repro_torch.models import Model
from repro_torch.serve import engine as E
from repro_torch.serve.collectives import (PROGRAM_CACHE, ServeCollectives,
                                           Split, SwitchProgramCache)

TP = 2
CPU = "cpu"


def _fixture(arch, key=0, slots=4, seq=48):
    jm = JModel(jconfigs.get_smoke(arch))
    jp = jm.init(jax.random.key(key))
    model = Model(configs.get_smoke(arch))
    return (jm, jp, jm.init_cache(slots, seq), model,
            interop.params_from_reference(jp))


@pytest.fixture(scope="module")
def dense():
    return _fixture("acis-100m")


@pytest.fixture(scope="module")
def moe():
    return _fixture("qwen2-moe-a2-7b", key=1)


def _sc(cfg, **kw):
    kw.setdefault("cache", SwitchProgramCache())
    return ServeCollectives(cfg, TP, device=CPU, **kw)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


def _tree_close(a, b, tol):
    for la, lb in zip(tree.tree_leaves(a), tree.tree_leaves(b)):
        assert la.shape == lb.shape
        d = (la.float() - lb.float()).abs().max().item() if la.numel() \
            else 0.0
        assert d <= tol, d


def _reference_tp(fix, mode, toks, steps):
    """The reference's compiled TP decode logits from the same fixture."""
    jm, jp, jc, _, _ = fix
    sc = JSC.ServeCollectives(jm.cfg, TP, cache=JSC.SwitchProgramCache())
    dec = sc.decode_fn(jp, jc, mode=mode, donate=False)
    out, c = [], jc
    tok = jnp.asarray(toks[0])
    for step in range(steps):
        lg, c = dec(jp, tok, c, jnp.full(4, step, jnp.int32))
        out.append(np.asarray(lg))
        tok = jnp.asarray(toks[step + 1])
    return out


def _port_run(fix, sc, mode, toks, steps):
    _, _, _, model, tp = fix
    split = sc.shard_params(tp)
    cache = sc.shard_cache(model.init_cache(4, 48, device=CPU))
    dec = sc.decode_fn(split, cache, mode=mode)
    out = []
    for step in range(steps):
        lg, cache = dec(split, torch.from_numpy(toks[step]), cache,
                        torch.full((4,), step))
        out.append(lg)
    return out, cache


def _plain_run(fix, toks, steps):
    _, _, _, model, tp = fix
    cache = model.init_cache(4, 48, device=CPU)
    out = []
    for step in range(steps):
        lg, cache = model.decode_step(tp, torch.from_numpy(toks[step]),
                                      cache, torch.full((4,), step))
        out.append(lg)
    return out, cache


# ---------------------------------------------------------------------------
# numerics: compiled TP decode vs the plain (unsharded) path
# ---------------------------------------------------------------------------

def test_dense_compiled_decode_matches_plain(dense):
    cfg = dense[3].cfg
    sc = _sc(cfg)
    toks = [np.array([3, 5, 7, 9], np.int32)]
    # the plain run picks the greedy tokens every run is fed
    lp, cp = [], dense[3].init_cache(4, 48, device=CPU)
    for step in range(4):
        lg, cp = dense[3].decode_step(dense[4], torch.from_numpy(toks[-1]),
                                      cp, torch.full((4,), step))
        lp.append(lg)
        toks.append(lg.argmax(-1).numpy().astype(np.int32))
    lc, cc = _port_run(dense, sc, "compiled", toks, 4)
    ld, cd = _port_run(dense, sc, "direct", toks, 4)
    sc_p = _sc(cfg, config=CollectiveConfig(backend="acis",
                                            use_kernels=False))
    lk, ck = _port_run(dense, sc_p, "compiled", toks, 4)
    for c, d, k, p in zip(lc, ld, lk, lp):
        # compiled vs uncompiled-acis and vs no kernels: bit-exact
        assert torch.equal(c, d) and torch.equal(c, k)
        # vs the unsharded path: TP sums bf16 partials -> ulp-level slack
        _close(c, p, 3e-2)
    _tree_close(cc, cd, 0.0)
    _tree_close(cc, ck, 0.0)
    _tree_close(sc.unshard_cache(cc), cp, 3e-2)
    # the port's compiled TP against the reference's compiled TP
    for got, want in zip(lc, _reference_tp(dense, "compiled", toks, 4)):
        _close(got, want, 3e-2)


def test_every_rank_holds_the_same_logits(dense):
    """After the last all-reduce the ranks' copies are equal: rank 0's is
    the one ``decode_fn`` returns (``decode_step`` under the hook in the
    mesh gives every rank's)."""
    from repro_torch.models import decode as D
    from repro_torch.models import parallel as TPH

    model, tp = dense[3], dense[4]
    sc = _sc(model.cfg)
    split = sc.shard_params(tp)
    toks = [np.array([1, 2, 3, 4], np.int32)] * 3
    one, _ = _port_run(dense, sc, "compiled", toks, 3)
    cache = sc.shard_cache(model.init_cache(4, 48, device=CPU))
    for step in range(3):
        with sc.mesh, TPH.tensor_parallel(sc.hook("compiled")):
            lg, cache = D.decode_step(split, sc.cfg_local,
                                      torch.from_numpy(toks[step]), cache,
                                      torch.full((4,), step))
        assert lg.shape == (TP, 4, model.cfg.vocab)
        assert torch.equal(lg[0], lg[1]) and torch.equal(lg[0], one[step])


def test_moe_compiled_dispatch_combine_matches_plain(moe):
    """The MoE expert all-to-all (dispatch + Type-4 fused combine with the
    shared-expert all-reduce) through engine.compile vs plain moe.py, and
    vs the reference's compiled TP decode."""
    cfg = moe[3].cfg
    assert cfg.moe.n_shared, "smoke config must exercise the fused combine"
    sc = _sc(cfg)
    kinds = [name for name, _, _ in sc.decode_programs(4)]
    assert "serve_moe_alltoall" in kinds and "serve_moe_combine" in kinds
    toks = [np.array([11, 2, 250, 77], np.int32)]
    lp, cp = [], moe[3].init_cache(4, 48, device=CPU)
    for step in range(3):
        lg, cp = moe[3].decode_step(moe[4], torch.from_numpy(toks[-1]), cp,
                                    torch.full((4,), step))
        lp.append(lg)
        toks.append(lg.argmax(-1).numpy().astype(np.int32))
    lc, cc = _port_run(moe, sc, "compiled", toks, 3)
    sc_p = _sc(cfg, config=CollectiveConfig(backend="acis",
                                            use_kernels=False))
    lk, ck = _port_run(moe, sc_p, "compiled", toks, 3)
    for c, k, p in zip(lc, lk, lp):
        assert torch.equal(c, k)
        _close(c, p, 5e-2)
    _tree_close(cc, ck, 0.0)
    _tree_close(sc.unshard_cache(cc), cp, 5e-2)
    for got, want in zip(lc, _reference_tp(moe, "compiled", toks, 3)):
        _close(got, want, 5e-2)


def test_moe_compiled_path_under_recording(moe):
    """Same numerics with obs recording on, and the serve counters land."""
    cfg = moe[3].cfg
    toks = [np.array([4, 8, 15, 16], np.int32)]
    lp, _ = _plain_run(moe, toks, 1)
    with obs.recording() as rec:
        lc, _ = _port_run(moe, _sc(cfg), "compiled", toks, 1)
    _close(lc[0], lp[0], 5e-2)
    assert rec.counter("serve.program_cache_miss") >= 3
    assert rec.counter("compile.programs") >= 3


def test_fused_combine_stage_is_type4(moe):
    cfg = moe[3].cfg
    sc = _sc(cfg)
    jsc = JSC.ServeCollectives(moe[0].cfg, TP,
                               cache=JSC.SwitchProgramCache())
    by_name = {name: prog for name, prog, _ in sc.decode_programs(4)}
    assert "allreduce+alltoall" in by_name["serve_moe_combine"].explain()
    for mine, ref in ((sc.decode_programs(4), jsc.decode_programs(4)),
                      (sc.prefill_programs(4, 16),
                       jsc.prefill_programs(4, 16))):
        assert [(n, p.stage_kinds(), c) for n, p, c in mine] == \
            [(n, p.stage_kinds(), c) for n, p, c in ref]
        assert [[s.schedule for s in p.stages] for _, p, _ in mine] == \
            [[s.schedule for s in p.stages] for _, p, _ in ref]
    # analytic costs (the cost model's, for the paper's switch) are the
    # reference's, finite and ordered: a prefill pass moves more bytes
    # than a decode tick
    assert 0 < sc.decode_comm_time(4) < sc.prefill_comm_time(4, 16)
    assert sc.decode_comm_time(4) == pytest.approx(jsc.decode_comm_time(4),
                                                   rel=1e-9)
    assert sc.prefill_comm_time(4, 16) == pytest.approx(
        jsc.prefill_comm_time(4, 16), rel=1e-9)


# ---------------------------------------------------------------------------
# the split: specs, shard once, replicated leaves shared
# ---------------------------------------------------------------------------

def test_split_follows_the_reference_specs(dense):
    jm, jp, jc, model, tp = dense
    sc = _sc(model.cfg)
    jsc = JSC.ServeCollectives(jm.cfg, TP, cache=JSC.SwitchProgramCache())

    def flat(t):
        return {k: tuple(v) for k, v in _by_path(t).items()}
    assert flat(sc.param_specs(tp)) == flat(jsc.param_specs(jp))
    assert flat(sc.cache_specs(model.init_cache(4, 48, device="meta"))) \
        == flat(jsc.cache_specs(jc))
    split = sc.shard_params(tp)
    assert isinstance(split, Split) and sc.shard_params(split) is split
    assert split["embed"] is tp["embed"]           # P(): no rank dim
    assert split["lm_head"] is tp["lm_head"]
    wq = split["layers"]["pos0_self"]["attn"]["wq"]
    full = tp["layers"]["pos0_self"]["attn"]["wq"]
    n, d, q = full.shape
    assert wq.shape == (n, TP, d, q // TP)
    for r in range(TP):
        assert torch.equal(wq[:, r], full[..., r * q // TP:(r + 1) * q // TP])
    cache = model.init_cache(4, 48, device=CPU)
    cache["layers"]["pos0_self"]["k"].normal_()
    back = sc.unshard_cache(sc.shard_cache(cache))
    assert torch.equal(back["layers"]["pos0_self"]["k"],
                       cache["layers"]["pos0_self"]["k"])


def _by_path(t, prefix=""):
    if isinstance(t, dict):
        out = {}
        for k in sorted(t):
            out.update(_by_path(t[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: t}


# ---------------------------------------------------------------------------
# the engine on the compiled transport
# ---------------------------------------------------------------------------

def test_engine_on_compiled_collectives_matches_direct(dense, rng):
    """Full continuous-batching run over the compiled transport: identical
    completions to the uncompiled (direct-ring) transport, slots
    recycled."""
    _, _, _, model, tp = dense
    cfg = model.cfg
    reqs = [E.Request(rid=i,
                      prompt=rng.integers(0, cfg.vocab, 3 + i).astype(
                          np.int32),
                      max_new_tokens=4 + (i % 3))
            for i in range(5)]

    def run(mode):
        sc = _sc(cfg)
        eng = E.ServeEngine(model, tp, slots=2, max_seq=48, collectives=sc)
        eng._decode = sc.decode_fn(eng.params, eng.cache, mode=mode)
        for r in reqs:
            eng.submit(E.Request(rid=r.rid, prompt=r.prompt,
                                 max_new_tokens=r.max_new_tokens))
        return eng.run_to_completion()

    done_c = run("compiled")
    done_d = run("direct")
    assert len(done_c) == len(done_d) == 5
    for a, b in zip(done_c, done_d):
        assert (a.rid, a.tokens) == (b.rid, b.tokens)


def test_shared_program_cache_across_replicas(dense):
    """Two ServeEngine replicas sharing one SwitchProgramCache: the second
    replica's decode build is all cache hits — no recompiles, asserted via
    the obs counters."""
    _, _, _, model, tp = dense
    shared = SwitchProgramCache()
    prompt = np.arange(4, dtype=np.int32)

    def replica():
        sc = ServeCollectives(model.cfg, TP, cache=shared, device=CPU)
        eng = E.ServeEngine(model, tp, slots=2, max_seq=48, collectives=sc)
        eng.submit(E.Request(rid=0, prompt=prompt, max_new_tokens=2))
        return eng.run_to_completion()

    with obs.recording() as rec:
        done1 = replica()
        misses_after_first = rec.counter("serve.program_cache_miss")
        compiles_after_first = rec.counter("compile.programs")
        assert misses_after_first >= 1
        done2 = replica()
    assert done1[0].tokens == done2[0].tokens
    assert rec.counter("serve.program_cache_miss") == misses_after_first
    assert rec.counter("compile.programs") == compiles_after_first
    assert rec.counter("serve.program_cache_hit") > 0
    assert shared.stats()["hits"] > 0
    assert shared.stats()["misses"] == misses_after_first


def test_default_cache_is_process_wide(dense):
    sc = ServeCollectives(dense[3].cfg, TP, device=CPU)
    assert sc.cache is PROGRAM_CACHE


def test_tick_time_estimate_prefers_measured(dense):
    _, _, _, model, tp = dense
    sc = _sc(model.cfg)
    eng = E.ServeEngine(model, tp, slots=2, max_seq=48, collectives=sc)
    analytic = eng.tick_time_estimate()
    assert analytic == sc.decode_comm_time(2) > 0
    eng.submit(E.Request(rid=0, prompt=np.arange(3, dtype=np.int32),
                         max_new_tokens=2))
    eng.run_to_completion()
    assert eng.tick_time_estimate() == float(np.median(eng._tick_times))


def test_engine_cache_is_split_and_reset_along_the_slot_dim(dense):
    """The engine holds the rank-stacked cache ([n, tp, slots, ...]) and
    resets an admitted slot's rows on every rank."""
    _, _, _, model, tp = dense
    eng = E.ServeEngine(model, tp, slots=3, max_seq=16,
                        collectives=_sc(model.cfg))
    k = eng.cache["layers"]["pos0_self"]["k"]
    assert k.shape[:3] == (model.cfg.n_layers, TP, 3)
    k.fill_(1.0)
    eng._reset_slot_caches([1])
    assert k[:, :, 1].abs().sum() == 0 and k[:, :, 0].eq(1).all() \
        and k[:, :, 2].eq(1).all()


# ---------------------------------------------------------------------------
# SLO admission: the same verdicts as the reference
# ---------------------------------------------------------------------------

def test_slo_verdicts_equal_the_reference(dense):
    """The same requests, waits and tick estimates through both policies,
    with each package's compiled collectives bounding the time to the
    first token: the same admit / reject / defer verdicts (deadlines far
    from every boundary, so the wall clock between the two calls does not
    move one)."""
    jm, _, _, model, _ = dense

    class Stub:
        slots = 2

        def __init__(self, sc, tick):
            self.collectives, self._tick = sc, tick

        def tick_time_estimate(self):
            return self._tick

    # (prompt, new tokens, deadline s, waited s)
    cases = [(10, 10, 0.04, 0.0), (10, 10, 0.5, 0.0), (40, 4, 0.02, 0.0),
             (3, 2, 1.0, 2.0), (5, 5, None, 0.0), (200, 8, 0.9, 0.1),
             (200, 8, 0.1, 0.0)]
    verdicts = {}
    for pkg, sc, pol, req in (
            ("ref", JSC.ServeCollectives(jm.cfg, TP,
                                         cache=JSC.SwitchProgramCache()),
             JE.SLOPolicy, JE.Request),
            ("port", _sc(model.cfg), E.SLOPolicy, E.Request)):
        sc.prefill_comm_time(2, 1)              # build before the clock
        out = []
        for tick in (1e-3, None):
            for cap in (None, 1):
                p = pol(max_concurrent_prefills=cap)
                for i, (t, n, dl, waited) in enumerate(cases):
                    r = req(rid=i, prompt=np.arange(t, dtype=np.int32),
                            max_new_tokens=n, deadline_s=dl,
                            t_submit=time.monotonic() - waited)
                    out.append(p.decide(r, Stub(sc, tick), n_prefilling=1))
        verdicts[pkg] = out
    assert verdicts["port"] == verdicts["ref"]
    assert {"admit", "reject", "defer"} <= set(verdicts["port"])


def test_slo_reads_the_prefill_comm_time():
    """The compiled transport's prefill time bounds the time to the first
    token: a deadline the in-batch estimate meets rejects once the
    collectives' ``prefill_comm_time`` exceeds it."""
    class Coll:
        def __init__(self, t):
            self.t, self.asked = t, []

        def prefill_comm_time(self, batch, t):
            self.asked.append((batch, t))
            return self.t

    class Stub:
        slots = 2

        def __init__(self, coll):
            self.collectives = coll

        def tick_time_estimate(self):
            return 1e-3

    r = E.Request(rid=0, prompt=np.arange(8, dtype=np.int32),
                  max_new_tokens=1, deadline_s=5.0,
                  t_submit=time.monotonic())
    assert E.SLOPolicy().decide(r, Stub(None), 0) == "admit"
    fast, slow = Coll(1e-6), Coll(10.0)
    assert E.SLOPolicy().decide(r, Stub(fast), 0) == "admit"
    assert E.SLOPolicy().decide(r, Stub(slow), 0) == "reject"
    assert slow.asked == [(2, 8)]


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def test_rejects_indivisible_tp(dense):
    with pytest.raises(ValueError, match="n_kv_heads"):
        ServeCollectives(dense[3].cfg, 4, device=CPU)  # n_kv_heads=2


def test_rejects_unsupported_family():
    for name in ("rwkv6-1.6b", "recurrentgemma-9b"):
        with pytest.raises(NotImplementedError, match="dense/moe"):
            ServeCollectives(configs.get_smoke(name), 2, device=CPU)


def test_rejects_xla_backend(dense):
    with pytest.raises(ValueError, match="acis"):
        ServeCollectives(dense[3].cfg, 2, device=CPU,
                         config=CollectiveConfig(backend="xla"))
    with pytest.raises(ValueError, match="acis"):
        JSC.ServeCollectives(dense[0].cfg, 2, config=JConfig(backend="xla"))


def test_full_size_moe_at_tp8_is_rejected():
    """qwen2-moe-a2.7b's 60 experts do not split over 8 ranks; 4 do."""
    cfg = configs.get("qwen2-moe-a2.7b")
    with pytest.raises(ValueError, match="n_experts"):
        ServeCollectives(cfg, 8, device="meta")
    assert ServeCollectives(cfg, 4, device="meta").cfg_local.n_heads == 4


@pytest.mark.parametrize("mode", ["compiled", "direct", "xla"])
def test_ranks_route_alike_when_their_copies_differ(mode, rng):
    """Every rank routes on rank 0's copy of the tokens (the hook's
    ``moe_route_input``).  Rank copies that their own routers would send
    to different experts still give every rank the same MoE output (f32,
    within 1e-6 of its largest magnitude: the shared experts' reduce folds
    in each rank's own order), and with no shared experts every rank's
    output is the unsharded ``moe_ffn`` of rank 0's copy (within 1e-5)."""
    from repro_torch.models import moe as MOE
    from repro_torch.models import parallel as TPH

    cfg = configs.get_smoke("qwen2-moe-a2.7b")
    gen = torch.Generator().manual_seed(0)
    x = torch.from_numpy(rng.standard_normal(
        (4, 2, 1, cfg.d_model)).astype(np.float32))
    for m in (cfg.moe, dataclasses.replace(cfg.moe, n_shared=0)):
        sc = ServeCollectives(dataclasses.replace(cfg, moe=m), 4,
                              device=CPU, cache=SwitchProgramCache())
        p = MOE.init_moe(gen, cfg.d_model, m, cfg.activation, torch.float32)
        own = [MOE.top_k(torch.softmax(x[r] @ p["router"], -1), m.top_k)[1]
               for r in range(4)]
        assert any(not torch.equal(own[0], o) for o in own[1:])
        split = sc.shard_params({"moe": p})["moe"]
        with sc.mesh, TPH.tensor_parallel(sc.hook(mode)):
            y, _ = MOE.moe_ffn(split, x, m, cfg.activation)
        bound = y.abs().amax()
        for r in range(1, 4):
            assert (y[r] - y[0]).abs().max() <= 1e-6 * bound
        if not m.n_shared:
            want, _ = MOE.moe_ffn(p, x[0], m, cfg.activation)
            assert (y[0] - want).abs().max() <= 1e-5 * bound


def test_latency_folds_differ_by_rank_in_bf16(rng):
    """ROADMAP.md R4: at tp=4 the fused combine's reduce (the reference's
    latency fold) leaves the ranks' bf16 copies unequal, where the
    bandwidth ring of an attention all-reduce leaves them equal."""
    from repro_torch.core.types import TensorSpec

    cfg = configs.get_smoke("qwen2-moe-a2.7b")
    sc = ServeCollectives(cfg, 4, device=CPU, cache=SwitchProgramCache())
    x = torch.from_numpy(rng.standard_normal((4, 1, 128, 64)).astype(
        np.float32)).to(torch.bfloat16)
    keys = torch.zeros((4, 8, 2, 64), dtype=torch.bfloat16)
    comb = sc.program("serve_moe_combine", sc._trace_combine,
                      (TensorSpec((1, 128, 64), torch.bfloat16),
                       TensorSpec((8, 2, 64), torch.bfloat16)))
    ar = sc.program("serve_tp_allreduce", sc._trace_allreduce,
                    (TensorSpec((1, 128, 64), torch.bfloat16),))
    assert [s.schedule for s in comb.stages] == ["latency"]
    assert [s.schedule for s in ar.stages] == ["bandwidth"]
    with sc.mesh:
        fused, _ = comb(x, keys)
        (ring,) = ar(x)
    assert not all(torch.equal(fused[0], fused[r]) for r in range(1, 4))
    assert all(torch.equal(ring[0], ring[r]) for r in range(1, 4))
