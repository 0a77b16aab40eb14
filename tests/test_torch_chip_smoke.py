"""``chip_smoke.py``'s fused phase and its prefix_sum checks, rehearsed on
the CPU at small sizes.

On the CPU every kernel wrapper runs its plain version and launches
nothing, so the rehearsal shows the programs compile to the stages the
script expects, run, and pass the script's own checks — and that the
stated scan bound is tight enough to catch a scan that drops one tile's
carry.  The card runs the same code at full size.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import chunk_scan
from repro_torch.mesh import LocalMesh

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod         # dataclasses look it up
    try:
        spec.loader.exec_module(mod)
        yield mod
    finally:
        del sys.modules["chip_smoke"]


def test_fused_path_rehearsed_on_the_cpu(smoke):
    recs = smoke.fused_path(LocalMesh({"data": 8}, device="cpu"),
                            smoke.FUSED_SMOKE, 0, expect_kernels=False)
    by = {r["program"]: r for r in recs}
    assert list(by) == ["fig5_scan", "fig5_scan_2d", "nas_is_c", "map_rs",
                        "ag_map", "gcn_pubmed", "gcn_pubmed_baseline",
                        "powersgd_r4"]
    assert by["fig5_scan"]["stages"] == ["scan+allgather"]
    assert by["fig5_scan_2d"]["stages"] == ["scan+allgather"]
    assert by["nas_is_c"]["stages"] == ["allreduce+alltoall"]
    assert by["map_rs"]["stages"] == ["map+reduce_scatter"]
    assert by["ag_map"]["stages"] == ["allgather+map"]
    assert by["gcn_pubmed"]["stages"] == ["map"]
    assert by["gcn_pubmed_baseline"]["stages"] == ["allgather", "map"]
    # one prefix_sum per Fig. 5 call by the plan; none launched on a CPU
    for name in ("fig5_scan", "fig5_scan_2d"):
        assert by[name]["launches_per_call"]["prefix_sum"] == 1
        after = by[name]["checks"]["after"]
        assert after["ranks_identical"] and after["rerun_err_over_bound"] <= 1
        assert after["rerun_differing_elements"] == 0   # cumsum: one order
        assert by[name]["checks"]["step2"]["kernels_err_over_bound"] <= 1
    for r in recs:
        assert r["launches"]["prefix_sum"] == 0
        assert sum(r.get("launches_per_call", {"": 0}).values()) == \
            r.get("launches_per_call", {}).get("prefix_sum", 0)
    assert len(by["powersgd_r4"]["ms"]) == 3


def test_prefix_checks_rehearsed_on_the_cpu(smoke, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    gen = torch.Generator().manual_seed(0)
    r = smoke.prefix_checks(torch.device("cpu"), gen)
    assert r["cases"] == 20 and r["max_abs_err"] == 0.0
    assert 0 < r["max_err_over_bound"] <= 1


def test_quant_hop_checks_rehearsed_on_the_cpu(smoke, monkeypatch):
    """The kernels phase's quant_hop checks at a small largest hop: every
    hop of the 8-ring on one axis and over the second of two, random,
    exact and NaN rows (7 hops x (3 random + exact + NaN) x 2 meshes),
    every hop of both rings of pod 2 x data 4 at 3 random row counts
    ((3 + 1) x 3), and 7 at the largest hop."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    gen = torch.Generator().manual_seed(0)
    r = smoke.quant_hop_checks(torch.device("cpu"), gen, big_rows=40)
    assert r["cases"] == 7 * 5 * 2 + 4 * 3 + 7 and r["max_abs_err"] == 0.0


def test_int8_hopquant_sync_counts_quant_hops(smoke):
    """What the compressed phase holds its launch counts to: n - 1
    ``quant_hop`` launches per int8_hopquant EF stage (the encoded ring's
    fused hops), and no elementwise ``quant_combine``."""
    from repro_torch import core as acis
    from repro_torch.configs.acis_100m import SMOKE, grad_leaf_specs

    mesh = LocalMesh({"data": 8}, device="meta")
    eng = acis.make_engine("acis_compressed", compressor="int8_hopquant")
    eng.init_arenas({k: torch.empty((8,) + s, dtype=dt, device="meta")
                     for k, s, dt in grad_leaf_specs(SMOKE)}, mesh=mesh)
    compiled = eng.last_sync_program()
    per_sync = smoke.expected_launches(compiled, mesh)
    ef = sum(st.kind == "ef_allreduce" for st in compiled.stages)
    assert ef > 0 and per_sync["quant_hop"] == 7 * ef
    assert per_sync["quant_combine"] == per_sync["fused_hop"] == 0
    from repro_torch.kernels import quant_combine
    assert smoke.kernel_modules()["quant_hop"] == (quant_combine,
                                                   "hop_launches")
    assert "quant_hop" in smoke.SOURCES and "quant_hop" in smoke.RING_OPS


def test_compressed_path_rehearsed_on_the_cpu(smoke):
    """The int8_hopquant phase at the smoke config: kernel and plain syncs
    bitwise equal, every rank the same totals, the EF identity within its
    bound; nothing launched on a CPU."""
    from repro_torch.configs.acis_100m import SMOKE
    rec = smoke.compressed_path(LocalMesh({"data": 8}, device="cpu"), SMOKE,
                                0, "int8_hopquant", expect_kernels=False)
    assert rec["bitwise_equal_to_plain"] and rec["max_rank_diff"] == 0.0
    assert rec["ef_identity_err_over_bound"] <= 1
    assert rec["launches_per_sync"]["quant_hop"] > 0
    assert sum(rec["launches"].values()) == 0


@pytest.mark.parametrize("shape", [(8, 3 * 4096 + 123), (2, 1000, 64)])
def test_scan_bound_catches_a_dropped_tile_carry(smoke, shape):
    """A scan that loses one tile's total from the carries of the tiles
    after it fails the stated bound; the plain cumsum meets it.  Tiles
    are the kernel's: 8,192 rows of one lane, or 256 rows of 32 lanes."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    exact, tol = smoke.scan_tolerance(x, 1)
    assert smoke.scan_err(torch.cumsum(x, 1), exact, tol, "cumsum") <= 1
    _, _, _, lb, tiles = chunk_scan.layout(shape, 1)
    rows = 256 // lb * chunk_scan.ROWS
    assert tiles > 1
    total = x[:, :rows].sum(1, keepdim=True)     # tile 0 of each column
    if x.dim() == 3:
        total[..., lb:] = 0                       # ...of one block's lanes
    bad = torch.cumsum(x, 1)
    bad[:, rows:] -= total
    with pytest.raises(AssertionError, match="stated bound"):
        smoke.scan_err(bad, exact, tol, "a dropped carry")


# ---------------------------------------------------------------------------
# the serve phase and the rwkv6_recurrence checks
# ---------------------------------------------------------------------------

def test_serve_path_rehearsed_on_the_cpu(smoke):
    from repro_torch.configs.rwkv6_1_6b import SMOKE
    pre, eng, eng32 = smoke.serve_path(SMOKE, 0, smoke.SERVE_SMOKE,
                                       device="cpu", expect_kernels=False)
    assert pre["program"] == "prefill_decode" and eng["program"] == "engine"
    assert eng32["program"] == "engine_f32" and eng32["dtype"] == "float32"
    assert pre["params"] == 494_720
    assert len(pre["prefill_ms_kernels"]) == len(pre["prefill_ms_plain"]) \
        == 2
    # on a CPU the wrapper runs the plain version: bitwise equal runs
    assert pre["kernel_vs_plain"]["logit_err_over_bound"] == 0.0
    assert pre["prefill_vs_decode"]["logit_err_over_bound"] <= 1
    f32 = pre["f32_check"]
    assert f32["kernel_vs_plain"]["logit_err_over_bound"] == 0.0
    assert f32["kernel_vs_plain"]["tokens_compared"] > 0
    assert f32["prefill_vs_decode"]["cache_err_over_bound"] <= 1
    assert eng32["fresh_engine_tokens_compared"] \
        == eng32["generated_tokens"]
    assert pre["launches_per_call"] == {"prefill": 2, "decode_step": 2}
    assert eng["reused_slot_requests"] == 2
    assert eng["counters"]["serve.admitted"] == 4
    assert eng["fresh_engine_tokens_compared"] > 0
    for rec in (pre, eng, eng32):
        assert sum(rec["launches"].values()) == 0     # nothing on a CPU


def test_wkv_checks_rehearsed_on_the_cpu(smoke, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    gen = torch.Generator().manual_seed(0)
    r = smoke.wkv_checks(torch.device("cpu"), gen,
                         shapes=((2, 1, 4, 64, 64), (1, 37, 2, 16, 8)))
    assert r["cases"] == 16 and r["max_abs_err"] == 0.0
    assert 0 < r["max_err_over_bound"] <= 1


def test_wkv_work_and_bound_at_the_prefill_shape(smoke):
    """About 109 MB and 3.8 GFLOP at [8, 512, 32, 64] bf16: on an H100
    the f32 operations (0.056 ms at 67 TFLOP/s) bound it, not the bytes
    (0.033 ms at 3.35 TB/s); at decode the state's bytes do."""
    nbytes, flops = smoke.wkv_work(8, 512, 32, 64, 64, 2)
    assert 108e6 < nbytes < 110e6 and flops == 7 * 8 * 512 * 32 * 64 * 64
    assert flops / 67e12 > nbytes / 3.35e12
    nbytes, flops = smoke.wkv_work(8, 1, 32, 64, 64, 2)
    assert flops / 67e12 < nbytes / 3.35e12


def test_hold_logits_compares_tokens_up_to_the_first_near_tie(smoke):
    a = torch.tensor([[10.0, 9.9, 0.0], [10.0, 0.0, 1.0]])
    # row 0 is a near-tie (gap 0.1 < 2 * 2^-5 * 10): its flip is allowed
    b = torch.tensor([[9.9, 10.0, 0.0], [10.0, 0.1, 1.0]])
    r = smoke.hold_logits([a, a], [b, b], 2.0 ** -5)
    assert r["tokens_compared"] == 2 and r["tokens"] == 4
    with pytest.raises(AssertionError, match="near-tie"):
        smoke.hold_logits([a], [torch.tensor([[10.0, 9.9, 0.0],
                                              [9.0, 0.0, 9.5]])], 2.0 ** -5)
    with pytest.raises(AssertionError, match="the bound"):
        smoke.hold_logits([a], [a + torch.tensor([0.0, 0.0, 1.0])],
                          2.0 ** -5)
    # at the f32 check's bound the 0.1 gap is no tie: the flip fails
    with pytest.raises(AssertionError):
        smoke.hold_logits([a], [b], smoke.F32_REL)


# ---------------------------------------------------------------------------
# the hybrid serve phase and the rglru_scan checks
# ---------------------------------------------------------------------------

def test_serve_hybrid_path_rehearsed_on_the_cpu(smoke):
    """recurrentgemma's smoke config through the whole phase: prefill and
    decode kernel vs plain, prefill vs decode, a 40-token prompt past the
    16-token window, the engine (a 20-token request wraps its ring; two
    requests land in reused slots), then f32."""
    from repro_torch.configs.recurrentgemma_9b import SMOKE
    pre, eng, eng32 = smoke.serve_path(SMOKE, 0, smoke.SERVE_HYBRID_SMOKE,
                                       device="cpu", expect_kernels=False,
                                       phase="serve_hybrid")
    assert pre["phase"] == eng["phase"] == "serve_hybrid"
    assert pre["kernel"] == "rglru_scan"
    assert pre["params"] == 251_072
    # 4 lru layers (one period's two and the remainder's two)
    assert pre["launches_per_call"] == {"prefill": 4, "decode_step": 4}
    assert eng["launches_per_tick"] == {"rglru_scan": 4}
    # on a CPU the wrapper runs the plain version: bitwise equal runs
    assert pre["kernel_vs_plain"]["logit_err_over_bound"] == 0.0
    assert pre["long_prefill"]["logit_err_over_bound"] == 0.0
    assert pre["long_prefill"]["prompt"] == 40
    assert pre["prefill_vs_decode"]["logit_err_over_bound"] <= 1
    f32 = pre["f32_check"]
    assert f32["prefill_vs_decode"]["logit_err_over_bound"] <= 1
    assert f32["prefill_vs_decode"]["cache_err_over_bound"] <= 1
    assert f32["long_prefill"]["cache_err_over_bound"] == 0.0
    assert eng["reused_slot_requests"] == 2
    assert eng32["fresh_engine_tokens_compared"] \
        == eng32["generated_tokens"]
    for rec in (pre, eng, eng32):
        assert sum(rec["launches"].values()) == 0     # nothing on a CPU


def test_serve_launch_check_names_the_models_kernel(smoke):
    from repro_torch.configs.recurrentgemma_9b import CONFIG as RG
    from repro_torch.configs.rwkv6_1_6b import CONFIG as RW
    assert smoke.serve_kernel(RG) == ("rglru_scan", 26)
    assert smoke.serve_kernel(RW) == ("rwkv6_recurrence", 24)
    counts = {"rwkv6_recurrence": 0, "rglru_scan": 26 * 3}
    smoke.check_serve_launches(counts, RG, 3, "three calls")
    with pytest.raises(AssertionError, match="rglru_scan launched"):
        smoke.check_serve_launches(counts, RG, 2, "two calls")
    with pytest.raises(AssertionError, match="rwkv6_recurrence launched"):
        smoke.check_serve_launches(dict(counts, rwkv6_recurrence=1), RG, 3,
                                   "a stray launch")


def test_rglru_checks_rehearsed_on_the_cpu(smoke):
    gen = torch.Generator().manual_seed(0)
    r = smoke.rglru_checks(torch.device("cpu"), gen,
                           shapes=((2, 1, 64), (None, 30, 4),
                                   (3, 37, 100)))
    assert r["cases"] == 11 and r["max_abs_err"] == 0.0
    assert 0 < r["max_err_over_bound"] <= 1


def test_rglru_work_and_bound_at_the_prefill_shape(smoke):
    """[8, 512, 4096] f32: a and b read, h written (201,326,592 B) plus
    the state in and out; bytes bound it on an H100 (0.060 ms at 3.35
    TB/s) far above the 2 flops per step."""
    nbytes, flops = smoke.rglru_work(8, 512, 4096)
    assert nbytes == 3 * 8 * 512 * 4096 * 4 + 2 * 8 * 4096 * 4
    assert flops == 2 * 8 * 512 * 4096
    assert nbytes / 3.35e12 > flops / 67e12
    assert 0.0600 < nbytes / 3.35e12 * 1e3 < 0.0602



def test_hop_checks_cover_both_rings_of_the_hierarchical_mesh(smoke,
                                                               monkeypatch):
    """fused_hop's checks hold every hop of the data ring ([A, n, B] =
    [2, 4, chunk]) and the pod ring ([1, 2, 4 x chunk]) of pod 2 x data
    4, beside the flat ring and the second axis of two."""
    assert ({"pod": 2, "data": 4}, "data") in smoke.HOP_VIEWS
    assert ({"pod": 2, "data": 4}, "pod") in smoke.HOP_VIEWS
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    gen = torch.Generator().manual_seed(0)

    def data(shape, dtype):
        if dtype == torch.int8:
            return torch.randint(-128, 128, shape, generator=gen,
                                 dtype=torch.int8)
        return torch.randn(shape, generator=gen).to(dtype)

    monkeypatch.setattr(smoke, "HOP_VIEWS", smoke.HOP_VIEWS[2:])
    r = smoke.hop_checks(torch.device("cpu"), gen, lambda s, d: data(
        tuple(min(x, 4096) for x in s), d))
    # (3 + 1) hops x 3 dtypes x 3 ops x 2 chunks, then the 7 hops of the
    # largest ring (at a CPU-sized chunk here)
    assert r["cases"] == 4 * 3 * 3 * 2 + 7 and r["max_abs_err"] == 0.0


def _hier_plan(smoke, backend, compressor="int8"):
    from repro_torch import core as acis
    from repro_torch.configs.acis_100m import SMOKE, grad_leaf_specs

    mesh = LocalMesh({"pod": 2, "data": 4}, device="meta")
    eng = acis.make_engine(backend, compressor=compressor,
                           outer_axis="pod")
    eng.init_arenas({k: torch.empty((2, 4) + s, dtype=dt, device="meta")
                     for k, s, dt in grad_leaf_specs(SMOKE)}, mesh=mesh)
    compiled = eng.last_sync_program()
    return compiled, smoke.expected_launches(compiled, mesh)


def test_hierarchical_launch_expectations_from_the_plan(smoke):
    """What the hierarchical phase holds its launch counts to, read off
    the plan: a fused hop per hop of every data reduce-scatter (3) and
    pod all-reduce (1), a quant hop per hop of every int8_hopquant data
    ring, n + 1 top-k accumulates per top-k stage; F2's program one
    reduce-scatter of 3 fused hops and one int8 pod hop."""
    compiled, per = _hier_plan(smoke, "acis_hierarchical")
    kinds = [(st.kind, st.axis, st.schedule) for st in compiled.stages]
    want_hop = 3 * kinds.count(("reduce_scatter", "data", "")) \
        + sum(1 for k in kinds if k[:2] == ("allreduce", "pod")
              and k[2] == "bandwidth")
    assert per["fused_hop"] == want_hop > 0
    assert per["fused_combine"] == sum(
        1 for k in kinds if k == ("allreduce", "pod", "latency"))
    assert per["fused_pack"] > 0 and per["quant_hop"] == 0
    for comp, kernel, each in (("int8_hopquant", "quant_hop", 3),
                               ("topk", "topk_accumulate", 5)):
        compiled, per = _hier_plan(smoke, "acis_hierarchical_compressed",
                                   comp)
        ef = [st for st in compiled.stages if st.kind == "ef_allreduce"]
        assert ef and all(st.axis == "data" for st in ef)
        assert per[kernel] == each * len(ef)


def test_hierarchical_path_rehearsed_on_the_cpu(smoke):
    """The hierarchical phase at the smoke config: kernels against plain
    bitwise, serial against overlapped dispatch bitwise, the mean within
    twice the ring bound of the flat acis sync, the EF identity within
    its bound, F2's program within its int8 bound; every record carries
    the compile ms and the cost model's program time, labelled as such;
    nothing launched on a CPU."""
    from repro_torch.configs.acis_100m import SMOKE

    recs = smoke.hierarchical_path(
        LocalMesh({"pod": 2, "data": 4}, device="cpu"), SMOKE, 0,
        expect_kernels=False, f2_local=4096)
    assert [(r["phase"], r["backend"], r.get("compressor"),
             r.get("program")) for r in recs] == [
        ("hierarchical", "acis_hierarchical", None, None)] + [
        ("hierarchical", "acis_hierarchical_compressed", c, None)
        for c in smoke.COMPRESSORS] + [
        ("hierarchical", "acis_hierarchical_compressed", None,
         "f2_compressed_reduce")]
    sync = recs[0]
    assert sync["serial_bitwise_equal_to_overlapped"]
    assert sync["multi_axis_waves"] > 0 and sync["streams"] == []
    assert sync["launches_per_sync"]["fused_hop"] > 0
    assert sync["max_abs_diff_vs_flat_acis"] > 0       # another fold order
    for r in recs[1:4]:
        assert r["bitwise_equal_to_plain"]
        assert r["ef_identity_err_over_bound"] <= 1
    f2 = recs[4]
    assert f2["launches_per_call"]["quant_hop"] == 1
    assert f2["launches_per_call"]["fused_hop"] == 3
    assert f2["codecs"][2] == ["int8_b256"] and f2["max_err_over_bound"] <= 1
    for r in recs:
        assert r["compile_ms"] > 0 and r["cost_model_program_time_s"] > 0
        assert "not a time on this card" in r["cost_model"]
        assert sum(r["launches"].values()) == 0
        assert r["mesh"] == {"pod": 2, "data": 4}


# ---------------------------------------------------------------------------
# the sim, tune and elastic phases
# ---------------------------------------------------------------------------

def _full_width_sync(smoke, backend, compressor, sizes):
    from repro_torch import core as acis
    from repro_torch import tree
    from repro_torch.configs.acis_100m import CONFIG, grad_leaf_specs
    from repro_torch.core.types import TensorSpec

    specs = grad_leaf_specs(CONFIG)
    _, treedef = tree.tree_flatten({k: 0 for k, _, _ in specs})
    eng = acis.make_engine(backend,
                           outer_axis="pod" if "pod" in sizes else None,
                           **({"compressor": compressor} if compressor
                              else {}))
    return eng._sync_program(treedef, tuple(TensorSpec(s, dt)
                                            for _, s, dt in specs),
                             None, axis_sizes=sizes)


def test_sim_launch_expectations_at_full_width(smoke):
    """One elementwise combine a ring step: 70 a simulated acis sync (10
    bucket rings of 8), 40 a hierarchical one, 70 quant_combine for
    int8_hopquant, two topk_accumulate per topk EF stage (12 leaves)."""
    want = {"acis": {"fused_combine": 70},
            "acis_hierarchical": {"fused_combine": 40},
            "int8_hopquant": {"quant_combine": 70},
            "topk": {"topk_accumulate": 24}}
    for backend, comp, sizes in smoke.SIM_SYNCS:
        c = _full_width_sync(smoke, backend, comp, sizes)
        got = smoke.sim_expected_launches(c, sizes)
        assert {k: v for k, v in got.items() if v} == want[comp or backend]


def test_sim_path_rehearsed_on_the_cpu(smoke):
    from repro_torch.configs.acis_100m import SMOKE

    recs = smoke.sim_path(SMOKE, 0, device="cpu", scan_local=5000,
                          expect_kernels=False)
    by = {r["program"]: r for r in recs}
    assert list(by) == ["acis", "acis_hierarchical",
                        "acis_compressed[int8_hopquant]",
                        "acis_compressed[topk]",
                        "acis[masked, dead rank 3]", "fig5_scan"]
    per = {k: {n: c for n, c in r["launches_per_run"].items() if c}
           for k, r in by.items()}
    assert per["acis"] == {"fused_combine": 14}        # 2 rings of 8
    assert per["acis_hierarchical"] == {"fused_combine": 8}
    assert per["acis_compressed[int8_hopquant]"] == {"quant_combine": 14}
    assert per["acis_compressed[topk]"] == {"topk_accumulate": 24}
    assert per["fig5_scan"] == {"prefix_sum": 1}
    for r in recs:
        assert not any(r["launches"].values())       # the CPU launches none
        assert r["cost_model_t_end_s"] > 0 and "cost model" in r["cost_model"]
    assert by["acis_compressed[topk]"]["topk_err_over_bound"] <= 1
    assert not by["acis_compressed[topk]"]["bitwise_to_executed"]
    assert by["acis"]["bitwise_to_executed"]
    assert all(v <= 1 for v in by["fig5_scan"]["err_over_bound"].values())


def test_sim_phase_fails_on_a_wrong_ring_walk(smoke, monkeypatch):
    """A ring step folding the wrong chunk cannot pass the sim phase."""
    from repro_torch.cgra import simulate
    from repro_torch.configs.acis_100m import SMOKE

    real = simulate.ring_reduce_scatter

    def off_by_one(x, combine):
        return real(torch.roll(x, 1, dims=1), combine)
    monkeypatch.setattr(simulate, "ring_reduce_scatter", off_by_one)
    with pytest.raises(AssertionError):
        smoke.sim_sync(SMOKE, 0, "acis", None, {"data": 8},
                       torch.device("cpu"), expect_kernels=False)


def test_tune_path_rehearsed_on_the_cpu(smoke):
    from repro_torch.configs.acis_100m import SMOKE

    r = smoke.tune_path(SMOKE, 0, device="cpu")
    for backend in ("acis", "acis_hierarchical"):
        assert len(r[backend]["t_end_ms"]) == 3
        assert r[backend]["clock"] == "perf_counter (host)"
        assert r[backend]["self_replay_match"] == 1.0
    assert r["fit"]["n_stages"] > 0
    assert r["chrome_trace"]["stage_slices"] == r["acis_hierarchical"][
        "stages"]
    assert r["drift"]["priced_spans"] > 0
    assert r["autotune"]["db_hit"]
    assert r["autotune"]["err_over_ring_bound"] <= 1


def test_tune_phase_fails_when_the_db_never_hits(smoke, monkeypatch):
    """A DB that never hits makes the second compile search again: the
    phase fails.  (The search itself is stubbed to its bookkeeping, which
    is all the check reads.)"""
    import importlib

    from repro_torch.configs.acis_100m import SMOKE
    from repro_torch.tune import TuneDB

    search = importlib.import_module("repro_torch.tune.search")

    def stub(build, *, base, **kw):
        search.SEARCHES_RUN += 1
        return search.SearchResult({}, 0.0, 0.0, 0)
    monkeypatch.setattr(search, "search", stub)
    monkeypatch.setattr(TuneDB, "lookup", lambda self, key: None)
    with pytest.raises(AssertionError, match="did not hit the DB"):
        smoke.tune_path(SMOKE, 0, device="cpu", runs=1)


def test_elastic_path_rehearsed_on_the_cpu(smoke):
    from repro_torch.configs.acis_100m import SMOKE

    recs = smoke.elastic_path(SMOKE, 0, device="cpu", steps=1,
                              expect_kernels=False)
    assert [r.get("backend", r.get("program")) for r in recs] == \
        ["acis", "acis_hierarchical", "sync_with_deadline"]
    for r in recs[:2]:
        assert r["live_ranks"] == 7 and r["bitwise_kernels_vs_plain"]
        assert r["err_over_ring_bound"] <= 1
        assert r["recompile"]["reuse_frac"] == 1.0
    assert recs[2]["attempts"] == 2 and recs[2]["masked"] == [5]


def test_elastic_phase_fails_when_the_mask_is_ignored(smoke, monkeypatch):
    """A masked sync that reduces every rank cannot pass the phase: the
    live mean check sees rank 3's contribution."""
    from repro_torch.configs.acis_100m import SMOKE
    from repro_torch.core import api

    real = api.CollectiveEngine._local_alive
    monkeypatch.setattr(api.CollectiveEngine, "_local_alive",
                        lambda self, m: torch.ones_like(real(self, m)))
    with pytest.raises(AssertionError, match="live mean"):
        smoke.elastic_path(SMOKE, 0, device="cpu", steps=1,
                           expect_kernels=False)


def test_fp8_hop_checks_rehearsed_on_the_cpu(smoke):
    """F3's card check: on the CPU the kernels' plain versions compute the
    fp8 hops in f32, rounded once to fp8."""
    r = smoke.fp8_hop_checks(torch.device("cpu"),
                             torch.Generator().manual_seed(0))
    assert r == {"cases": 32, "bitwise": True}
