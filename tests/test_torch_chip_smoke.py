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
        per = r.get("launches_per_call", {})
        # the fused allreduce+alltoall stage's reduce: n-1 elementwise
        # fused_combine hops a call; one gather launch a ring all-gather
        # (the gathering stages'); every other program launches only its
        # prefix_sum
        hops = 7 if r["program"] == "nas_is_c" else 0
        gathers = int(r["program"] in ("fig5_scan", "fig5_scan_2d", "ag_map",
                                       "gcn_pubmed_baseline"))
        assert per.get("fused_combine", 0) == hops
        assert per.get("fused_gather", 0) == gathers
        assert sum(per.values()) == per.get("prefix_sum", 0) + hops + gathers
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


@pytest.mark.parametrize("backend,comp,sizes,gathers", [
    ("acis", None, {"data": 8}, 10),
    ("acis_hierarchical", None, {"data": 4, "pod": 2}, 20),
    ("acis_compressed", "int8", {"data": 8}, 10),
    ("acis_compressed", "int8_hopquant", {"data": 8}, 20),
    ("acis_compressed", "topk", {"data": 8}, 0)])
def test_gather_launch_expectations_at_full_width(smoke, backend, comp,
                                                  sizes, gathers):
    """One ``fused_gather`` launch per ring all-gather of the acis-100m
    sync's plan: a bandwidth ring's second half (10 bucket rings of 8), a
    hierarchical sync's pod all-reduce and data all-gather (10 buckets of
    each), the int8 EF ring's int16 leaf and int8_hopquant's blocks and
    scales (10 stages), none for top-k's sparse ring.  A window that runs
    the plain sync too counts its gathers again."""
    c = _full_width_sync(smoke, backend, comp, sizes)
    per = smoke.expected_launches(c, LocalMesh(sizes, device="meta"))
    assert per["fused_gather"] == gathers
    both = smoke.with_plain_gathers(per)
    assert both == dict(per, fused_gather=2 * gathers)


def _note_gathers(smoke):
    """A noted run of ``fused_gather`` on the CPU: f32, bf16 from one
    element into its allocation (2 bytes off the 16-byte grid), int8 and
    the int8 EF ring's int16 sums, over both axes of pod 2 x data 4, the
    bf16 form twice."""
    from repro_torch.kernels import fused_combine as fc

    plans = smoke.GatherPlans().start()
    kernel = plans.kernel
    mesh = LocalMesh({"pod": 2, "data": 4}, device="cpu")
    g = torch.Generator().manual_seed(0)
    with mesh:
        for ax, dtype, offset in (("data", torch.float32, 0),
                                  ("pod", torch.bfloat16, 1),
                                  ("pod", torch.bfloat16, 1),
                                  ("data", torch.int8, 0),
                                  ("data", torch.int16, 0)):
            flat = torch.randint(-100, 100, (2 * 4 * 7 + offset,),
                                 generator=g).to(dtype)
            first = flat[offset:].view(2, 4, 7)
            fc.fused_gather(first, dim=mesh.dim(ax), rank_ndim=2)
    plans.stop()
    assert fc.fused_gather is kernel
    return plans


def test_gather_plans_note_every_form_and_hold_it(smoke):
    """``GatherPlans`` notes each form of gather once, by mesh, axis,
    shape, dtype and offset from the grid, and holds ``fused_gather``
    against the ring's loop at each: on the CPU the wrapper's plain
    version, on the card the kernel."""
    plans = _note_gathers(smoke)
    assert sorted(plans.seen.values()) == [1, 1, 1, 2]
    assert sorted(k[-1] for k in plans.seen) == [0, 0, 0, 2]
    rec = plans.hold(device="cpu")
    assert rec == {"phase": "gather_plans", "forms": 4, "gathers": 5,
                   "dtypes": ["bfloat16", "float32", "int16", "int8"],
                   "off_grid": 1, "max_abs_err": 0.0}


def test_gather_plans_catch_a_gather_off_by_one_byte(smoke, monkeypatch):
    """A gather that writes one byte wrong fails the hold."""
    from repro_torch.kernels import fused_combine as fc

    plans = _note_gathers(smoke)
    kernel = fc.fused_gather

    def wrong(first, *, dim, rank_ndim):
        out = kernel(first, dim=dim, rank_ndim=rank_ndim)
        out.view(torch.uint8).view(-1)[-1] ^= 1
        return out
    monkeypatch.setattr(fc, "fused_gather", wrong)
    with pytest.raises(AssertionError, match="differs from the loop in 1 "
                                             "bytes"):
        plans.hold(device="cpu")


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


# ---------------------------------------------------------------------------
# the tensor-parallel serve phases (serve_tp_dense, serve_tp_moe)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen3-8b", "qwen2-moe-a2.7b"])
def test_tp_serve_path_rehearsed_on_the_cpu(smoke, name):
    """Both phases at smoke size on LocalMesh({"tp": 2}): every mode runs,
    compiled equals compiled-without-kernels (and, dense, direct) bit for
    bit, every row's logits sit within BF16_REL of the unsharded ones (a
    MoE stack's direct, xla and unsharded runs replaying the compiled
    run's expert choices, and its f32 check within F32_REL), every rank's
    logits within BF16_REL of rank 0's, the engine completes every
    request, and the CPU launches nothing."""
    from repro_torch import configs

    pre, eng = smoke.tp_serve_path(configs.get_smoke(name), 0,
                                   smoke.SERVE_TP_SMOKE, device="cpu",
                                   expect_kernels=False, phase="serve_tp")
    assert pre["program"] == "prefill_decode" and eng["program"] == "engine"
    assert set(pre["decode_ms_per_tick"]) == set(smoke.TP_MODES)
    assert all(v <= 1 for v in pre["vs_unsharded"].values())
    assert pre["compiled_bitwise_to_plain"]
    moe = name.startswith("qwen2")
    progs = pre["decode_programs"]
    if moe:
        assert progs["serve_moe_combine"]["stages"] == ["allreduce+alltoall"]
        assert progs["serve_moe_alltoall"]["stages"] == ["alltoall"]
        sizes = smoke.SERVE_TP_SMOKE
        calls = (sizes.prompt + sizes.steps) * 2            # 2 MoE layers
        for mode in ("direct", "xla", "unsharded"):
            apart, rows = pre["routing_rows_apart"][mode]
            assert 0 <= apart <= rows == calls * sizes.batch
        f32 = pre["f32_check"]
        assert f32["layers"] == 2 and f32["rows"] == 8
        assert 4 * f32["rows_compared"] >= 3 * f32["rows"]
        assert max(f32["prefill_err_over_bound"],
                   f32["decode_err_over_bound"]) <= 1
    else:
        assert pre["compiled_bitwise_to_direct"]
        assert list(progs) == ["serve_tp_allreduce"]
        assert progs["serve_tp_allreduce"]["calls"] == 4    # 2 layers x 2
    spread = pre["rank_spread"]
    assert spread["ranks"] == 2 and spread["ticks"] == 3
    assert max(spread["rank_vs_rank0_err_over_bound"],
               spread["rank0_vs_decode_fn_err_over_bound"]) <= 1
    assert pre["decode_comm_time_s"] > 0 and "cost model" in pre["cost_model"]
    assert eng["generated_tokens"] == sum(
        n for _, n in smoke.SERVE_TP_SMOKE.requests)
    assert eng["program_cache"]["hits"] > 0
    for rec in (pre, eng):
        assert sum(rec["launches"].values()) == 0     # nothing on a CPU


def test_tp_phase_fails_when_a_hook_drops_the_reduction(smoke, monkeypatch):
    """A direct hook that skips its all-reduce cannot pass the dense
    phase: compiled and direct must agree bit for bit."""
    from repro_torch import configs
    from repro_torch.serve import collectives as SC

    monkeypatch.setattr(SC.DirectTPHook, "_all_reduce", lambda self, x: x)
    with pytest.raises(AssertionError, match="compiled and direct"):
        smoke.tp_serve_path(configs.get_smoke("qwen3-8b"), 0,
                            smoke.SERVE_TP_SMOKE, device="cpu",
                            expect_kernels=False)


def test_rank_check_fails_when_ranks_route_apart(smoke, monkeypatch):
    """``rank_spread`` holds every rank's logits to rank 0's.  With rank
    1's router reading another copy of the tokens than rank 0's, rank 1
    gathers other tokens' expert outputs, and the check fails."""
    from repro_torch import configs, tree
    from repro_torch.models import Model
    from repro_torch.serve import collectives as SC

    cfg = configs.get_smoke("qwen2-moe-a2.7b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    sc = SC.ServeCollectives(cfg, 2, device="cpu",
                             cache=SC.SwitchProgramCache())
    split = sc.shard_params(params)
    toks = torch.randint(0, cfg.vocab, (2, 4),
                         generator=torch.Generator().manual_seed(1))
    cache = sc.shard_cache(model.init_cache(2, 8, device="cpu"))
    lg, cache = sc.prefill_fn()(split, toks, cache)
    feed = [lg.argmax(-1)]
    want = [sc.decode_fn()(split, feed[0],
                           tree.tree_map(torch.clone, cache), 4)[0]]
    ok = smoke.rank_spread(sc, split, tree.tree_map(torch.clone, cache),
                           feed, 4, want)
    assert ok["rank_vs_rank0_err_over_bound"] <= 1
    monkeypatch.setattr(SC._TPBase, "moe_route_input",
                        lambda self, xt: torch.cat([xt[:1], -xt[1:]]))
    with pytest.raises(AssertionError, match="ranks' logits differ"):
        smoke.rank_spread(sc, split, cache, feed, 4, want)


def test_tp_launches_at_the_phases_full_sizes(smoke):
    """Read off the full-size programs (compiled on meta): a qwen3-8b
    tick at tp=8 and batch 8 is 72 bandwidth all-reduces, 7 fused_hop
    and one fused_gather each; a qwen2-moe tick at tp=4 and batch 4 is
    24 bandwidth all-reduces, 24 all-to-alls and 24 fused combines (3
    fused_hop, one fused_gather and 3 elementwise fused_combine per
    layer)."""
    from repro_torch import configs
    from repro_torch.serve.collectives import ServeCollectives

    sc = ServeCollectives(configs.get("qwen3-8b"), 8, device="meta")
    assert smoke.tp_launches(sc.decode_programs(8), 8) == \
        {"fused_combine": 0, "fused_hop": 504, "fused_gather": 72}
    assert smoke.tp_launches(sc.prefill_programs(8, 512), 8) == \
        {"fused_combine": 0, "fused_hop": 504, "fused_gather": 72}
    sc = ServeCollectives(configs.get("qwen2-moe-a2.7b"), 4, device="meta")
    assert smoke.tp_launches(sc.decode_programs(4), 4) == \
        {"fused_combine": 72, "fused_hop": 72, "fused_gather": 24}


def test_train_path_rehearsed_on_the_cpu(smoke):
    """The train phase at SMOKE: the kernels-vs-plain step check on every
    backend, then the train_e2e run with its checkpoint, resume and
    descent checks (deterministic algorithms on, as on the card)."""
    from repro_torch.configs.acis_100m import SMOKE

    recs = smoke.train_path(SMOKE, 0, smoke.TRAIN_SMOKE, device="cpu",
                            expect_kernels=False)
    by = [(r["program"], r["backend"], r["compressor"]) for r in recs]
    assert by == [("sync_check", b, c) for b, c, _ in smoke.TRAIN_BACKENDS] \
        + [("train_e2e", "acis_compressed", "int8")]
    for r in recs[:-1]:
        assert r["bitwise_equal_to_plain"] and len(r["grads_ms"]) == 2
        assert any(r["launches_per_sync"].values())
        assert not any(r["launches"].values())        # CPU: plain versions
        # the smoke sizes' small leaves ride latency rings (R4): ranks
        # within rounding; at full width every ring is a bandwidth ring
        if r["ranks_bitwise"]:
            assert r["max_rank_spread"] == 0.0
    assert not recs[0]["ranks_bitwise"]
    e2e = recs[-1]
    assert e2e["resumed_bitwise_equal"] and e2e["steps"] == 30
    assert e2e["example"] == "examples/torch_train_e2e.py"
    assert e2e["mesh"] == {"data": 4} and e2e["ckpt_at"] == 14
    # the example logs every max(steps // 20, 1)-th step
    assert [s for s, _ in e2e["curve"]] == list(range(30))
    assert e2e["nll_last"] < e2e["nll_first"] - smoke.TRAIN_SMOKE.bar
    assert len(e2e["step_ms"]) == 30 and e2e["ckpt_bytes"] > 0
    # no kernel of the int8 sync's own; its bucket packs are fused_pack
    assert e2e["launches_per_sync"]["fused_pack"] > 0
    assert not torch.are_deterministic_algorithms_enabled()


def test_train_phase_fails_when_the_resume_drops_the_residual(smoke,
                                                              monkeypatch):
    """The resume check is tight: a restore that loses the EF residual
    (the look-aside memory) is caught."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs.acis_100m import SMOKE

    real = ckpt.restore

    def lossy(d, like, **kw):
        st, step, extra = real(d, like, **kw)
        st.ef_residual = like.ef_residual           # zeros: mass lost
        return st, step, extra

    monkeypatch.setattr(ckpt, "restore", lossy)
    with pytest.raises(AssertionError, match="resumed run.s"):
        smoke.train_e2e(SMOKE, 0, smoke.TRAIN_SMOKE, torch.device("cpu"),
                        expect_kernels=False)


EXAMPLE_SMOKE_CFGS = ("quickstart", "qwen3-8b"), ("serve_batched",
                                                  "acis-100m")


def _example_cfgs():
    from repro_torch import configs
    return {name: configs.get_smoke(arch) for name, arch in EXAMPLE_SMOKE_CFGS}


def test_examples_path_rehearsed_on_the_cpu(smoke):
    """The examples phase on the CPU: every twin through its main and the
    phase's checks of what it returns; records JSON-ready, no launch."""
    import json

    recs = smoke.examples_path(_example_cfgs(), device="cpu",
                               expect_kernels=False)
    assert [r["program"] for r in recs] == list(smoke.EXAMPLES)
    json.dumps(recs)
    by = {r["program"]: r for r in recs}
    for r in recs:
        assert r["phase"] == "examples" and r["seconds"] > 0
        assert not any(r["launches"].values())
        assert r["max_memory_allocated"] is None
    assert by["quickstart"]["numbers"]["fig5_stages"] == ["scan+allgather"]
    assert by["quickstart"]["checks"]["welford_mean_rel"] <= 1e-5
    assert by["fused_collectives"]["numbers"]["dag_stages"] == \
        ["map+allreduce", "alltoall"]
    assert 0 < by["cgra_simulate"]["checks"]["fig5_err_over_bound"] <= 1
    assert by["serve_batched"]["numbers"]["replica2_new_compiles"] == 0
    # every group of kernels the card must see is a kernel the script
    # counts, and every twin has its groups
    names = set(smoke.kernel_modules())
    assert set(smoke.EXAMPLE_KERNELS) == set(smoke.EXAMPLES) | {"train_e2e"}
    for groups in smoke.EXAMPLE_KERNELS.values():
        assert groups and all(set(g) <= names for g in groups)


def _bump(out, *path, by=1e-3):
    *head, last = path
    for k in head:
        out = out[k]
    out[last] = out[last] + by


@pytest.mark.parametrize("name, perturb", [
    ("quickstart", lambda o: _bump(o, "welford_var", by=1e-4)),
    ("quickstart", lambda o: _bump(o, "fig5_out", by=1.0)),
    ("fused_collectives", lambda o: _bump(o, "ef_reduced")),
    ("fused_collectives", lambda o: _bump(o, "bf16_err", by=10.0)),
    ("hierarchical_sync", lambda o: _bump(o, "sync_err")),
    ("hierarchical_sync", lambda o: _bump(
        o, "programs", "acis_hierarchical_compressed", "rel_err", by=0.01)),
    ("cgra_simulate", lambda o: o["fig5"]["out"][3].add_(1e-2)),
    ("cgra_simulate", lambda o: _bump(o, "hierarchical", "rel_err",
                                      by=0.01)),
    ("serve_batched", lambda o: _bump(o, "replica2_new_compiles", by=1)),
])
def test_examples_phase_fails_on_a_perturbed_number(smoke, monkeypatch,
                                                    name, perturb):
    """Each twin's checks are tight enough to catch one of its returned
    numbers moved."""
    real = smoke.load_example

    def load(example):
        mod = real(example)
        main = mod.main

        def perturbed(*args, **kw):
            out = main(*args, **kw)
            perturb(out)
            return out
        mod.main = perturbed
        return mod

    monkeypatch.setattr(smoke, "load_example", load)
    monkeypatch.setattr(smoke, "EXAMPLES", (name,))
    with pytest.raises(AssertionError, match=name):
        smoke.examples_path(_example_cfgs(), device="cpu",
                            expect_kernels=False)
