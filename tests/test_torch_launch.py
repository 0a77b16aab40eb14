"""The dry-run path of the port (``repro_torch.launch`` and
``repro_torch.roofline``) at test scale, the counterparts of
``test_launch.py``: the cell matrix, every cell's inputs against the
reference's, probe composition, the HLO collective parser on the same
text, a cell built and analysed on a meta mesh, the roofline math at the
H100's peaks and the ``pure_dp`` specs; then the probes' linearity
against a whole-cell count, and the algorithmic FLOPs of all 40 cells."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.launch import cells as ref_cells
from repro.launch import shapes as ref_shapes
from repro.roofline import analysis as ref_analysis
from repro_torch import configs
from repro_torch.launch import cells, dryrun, shapes
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.mesh import LocalMesh
from repro_torch.roofline import analysis, profile, report


def test_shape_matrix_counts():
    all_cells = shapes.all_cells()
    assert len(all_cells) == 40                      # 10 archs × 4 shapes
    runnable = shapes.runnable_cells()
    assert len(runnable) == 32                       # 8 long_500k skips
    skipped = set(all_cells) - set(runnable)
    assert all(s == "long_500k" for _, s in skipped)
    ok, reason = shapes.applicable("nemotron-4-15b", "long_500k")
    assert not ok and "full-attention" in reason
    assert shapes.applicable("rwkv6-1.6b", "long_500k")[0]
    assert shapes.applicable("recurrentgemma-9b", "long_500k")[0]
    assert all_cells == ref_shapes.all_cells()
    assert runnable == ref_shapes.runnable_cells()
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in ref_shapes.SHAPES.items()}


def test_input_specs_every_cell_match_the_reference():
    """Meta stand-ins of the reference's ShapeDtypeStruct shapes and
    dtypes, leaf by leaf, for all 40 nominal cells."""
    for arch, shape in shapes.all_cells():
        got = cells.input_specs(arch, shape)
        want = ref_cells.input_specs(arch, shape)
        flat, _ = jax.tree_util.tree_flatten_with_path(want)
        from repro_torch.sharding.rules import leaves_with_paths
        port = leaves_with_paths(got)
        assert [jax.tree_util.keystr(p) for p, _ in flat] == \
            ["".join(f"['{k}']" for k in p) for p, _ in port], (arch, shape)
        for (_, w), (_, g) in zip(flat, port):
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape), (arch, shape)
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), \
                (arch, shape)


def test_probe_composition_exact():
    """The linear solver recovers a synthetic P(p,m) exactly."""
    O, E, Lmb, Lstep = 7.0, 3.0, 2.0, 5.0

    def P(p, m):
        return O + m * E + p * (m * Lmb + Lstep)

    costs = {(1, 1): {"x": P(1, 1)}, (2, 1): {"x": P(2, 1)},
             (1, 2): {"x": P(1, 2)}, (2, 2): {"x": P(2, 2)}}
    got = cells.compose_probe_costs(costs, n_periods=24, mb_cell=8,
                                    kind="train")
    assert abs(got["x"] - P(24, 8)) < 1e-9
    got2 = cells.compose_probe_costs(
        {(1, 1): {"x": O + Lstep}, (2, 1): {"x": O + 2 * Lstep}},
        n_periods=24, mb_cell=1, kind="prefill")
    assert abs(got2["x"] - (O + 24 * Lstep)) < 1e-9


HLO = """
  %all-reduce.1 = f32[16,128]{1,0} all-reduce(%x), replica_groups={}
  %ag = (bf16[4,256]{1,0}, bf16[4,256]{1,0}) all-gather-start(%a, %b)
  %agd = bf16[4,256]{1,0} all-gather-done(%ag)
  %p = f32[8]{0} collective-permute(%y), source_target_pairs={{0,1}}
  %rs = bf16[2,64]{1,0} reduce-scatter(%z), dimensions={0}
  %a2a = s8[3,5]{1,0} all-to-all(%q), dimensions={0}
  %ignore = f32[999]{0} add(%p, %p)
"""


def test_collective_bytes_parser_matches_the_reference():
    out = analysis.collective_bytes(HLO)
    assert out["bytes"]["all-reduce"] == 16 * 128 * 4
    assert out["bytes"]["all-gather"] == 2 * 4 * 256 * 2  # start only
    assert out["bytes"]["collective-permute"] == 32
    assert out["counts"]["all-reduce"] == 1
    assert out == ref_analysis.collective_bytes(HLO)


def test_build_and_analyze_smallest_cell():
    """The smallest rwkv6 train cell on a meta 2×4 mesh ('data'×'model'):
    the machinery the 256-rank dry run uses."""
    mesh = LocalMesh({"data": 2, "model": 4}, device="meta")
    small = shapes.ShapeCell("train_4k", 128, 8, "train")
    built = cells._build_with_cell(
        "rwkv6-1.6b", "train_4k", small, mesh,
        {"n_layers": 2, "scan_layers": False, "analysis_unroll": True,
         "attn_chunk": 128, "wkv_chunk": 64}, 2)
    assert built.counts["flops"] > 0 and built.counts["coll_bytes"] > 0
    assert built.memory["temp_bytes"] > 0
    roof = analysis.analyze(built)
    assert roof.t_compute > 0 and roof.bottleneck in (
        "compute", "memory", "collective")
    prof = profile.profile_log(built.log)
    assert prof["total_bytes"] == built.counts["coll_bytes"]
    assert set(prof["by_origin"]) <= {"all-gather/fwd", "all-reduce/fwd",
                                      "all-reduce/bwd",
                                      "reduce-scatter/bwd"}


def test_roofline_terms_math():
    """One second of each term at the H100 SXM's published peaks."""
    r = analysis.Roofline(arch="x", shape="train_4k", mesh="16dx16m",
                          chips=256, flops=989e12, hbm_bytes=3.35e12,
                          coll_bytes=450e9, coll_detail={},
                          model_flops=989e12 * 256)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 1.0) < 1e-9
    assert abs(r.t_collective - 1.0) < 1e-9
    assert abs(r.useful_flops_ratio - 1.0) < 1e-9
    assert abs(r.roofline_fraction - 1.0) < 1e-9
    assert analysis.POWER_LIMIT_W == 700
    assert "H100" in analysis.PEAK_SOURCE and "published" in \
        analysis.PEAK_SOURCE


def test_pure_dp_parallelism_specs():
    from repro_torch.sharding import rules
    mesh = make_host_mesh(2, 4, device="meta")
    shapes_t = {"layers": {"pos0_self": {"attn": {
        "wq": torch.empty((2, 64, 64), dtype=torch.bfloat16,
                          device="meta")}}}}
    tp = rules.spec_leaves(rules.param_specs(shapes_t, mesh))[0]
    dp = rules.spec_leaves(rules.param_specs(shapes_t, mesh, "pure_dp"))[0]
    assert "model" in tp and "model" not in dp
    assert rules.dp_axes(mesh, "pure_dp") == ("data", "model")
    prod = make_production_mesh(multi_pod=True)
    assert prod.device.type == "meta" and prod.shape == {
        "pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_probe_composition_equals_the_whole_cell(kind):
    """The linearity the reference assumes, checked: on a smoke config the
    four (two) probes compose to the whole cell's eager count — FLOPs,
    bytes and collective bytes."""
    base = dataclasses.replace(configs.get_smoke("acis-100m"),
                               **cells.ANALYSIS_OVERRIDES)
    mesh = LocalMesh({"data": 2, "model": 2}, device="meta")
    mb_batch, seq, n_periods, mb_cell = 2, 16, 3, 3

    def run(periods, mb):
        cfg = dataclasses.replace(base, n_layers=periods)
        if kind == "train":
            cell = shapes.ShapeCell("t", seq, mb_batch * mb, "train")
            built = cells.build_train(cfg, cell, mesh, microbatches=mb)
        else:
            cell = shapes.ShapeCell("p", seq, 4, "prefill")
            built = cells.build_serve(cfg, cell, mesh)
        return cells.probe_costs(built)

    ladder = [(1, 1), (2, 1)] + ([(1, 2), (2, 2)] if kind == "train"
                                 else [])
    costs = {k: run(*k) for k in ladder}
    got = cells.compose_probe_costs(costs, n_periods=n_periods,
                                    mb_cell=mb_cell if kind == "train"
                                    else 1, kind=kind)
    whole = run(n_periods, mb_cell if kind == "train" else 1)
    for k in ("flops", "coll_bytes"):
        assert got[k] == pytest.approx(whole[k], rel=1e-12), k
    if kind == "prefill":
        assert got["hbm_bytes"] == pytest.approx(whole["hbm_bytes"],
                                                 rel=1e-12)
    else:
        # the f32 accumulation buffers exist only at M >= 2 (one
        # microbatch returns its gradients as they are, as the
        # reference's _accumulate_grads does), so the (p, 1) probes miss
        # their zeros, adds and scale: the composed bytes run above the
        # whole cell's by that much, and only that much
        assert whole["hbm_bytes"] < got["hbm_bytes"] < \
            1.05 * whole["hbm_bytes"]


def test_model_flops_match_the_reference():
    for arch, shape in shapes.all_cells():
        assert analysis.model_flops_for(arch, shape) == \
            ref_analysis.model_flops_for(arch, shape), (arch, shape)


def test_dryrun_record_and_report(tmp_path):
    """One cell through ``run_cell`` (whole cell and probes) and the
    report's tables over its record."""
    out = tmp_path / "rwkv6-1.6b__decode_32k__sp.json"
    rec = dryrun.run_cell("rwkv6-1.6b", "decode_32k", False, str(out))
    assert rec["status"] == "ok" and out.exists()
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["probe_composition"]["n_periods"] == 24
    # the probes compose to the whole cell's count (exact linearity)
    for k, v in rec["whole_cell_counts"].items():
        comp = {"flops": rec["flops_per_device"],
                "hbm_bytes": rec["hbm_bytes_per_device"],
                "coll_bytes": rec["collective_bytes_per_device"]}[k]
        assert comp == pytest.approx(v, rel=1e-9), k
    rows = report.load(str(tmp_path))
    assert "rwkv6-1.6b" in report.roofline_table(rows)
    assert "rwkv6-1.6b" in report.dryrun_table(rows)
