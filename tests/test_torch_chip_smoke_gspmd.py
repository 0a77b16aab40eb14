"""``chip_smoke.py``'s phases of the GSPMD slice (``train_gspmd``,
``pipeline``, ``seq_parallel``, ``dryrun``), rehearsed on the CPU at
smoke sizes, and their full-size tables.

On the CPU no kernel launches (``rglru_scan_sp`` scans each chunk with
its plain form), so the rehearsal shows each phase runs its path and
passes the script's own checks, and that the checks catch a broken
handoff or a dropped carry.  The card runs the same code at full width.
"""

import pytest
import torch

import zoo_parity as Z


@pytest.fixture(scope="module")
def smoke():
    yield from Z.chip_smoke_module()


def test_train_gspmd_path_rehearsed_on_the_cpu(smoke):
    """The baseline on {"data": 2, "model": 2} (attention and FFN split):
    shard shapes, the f32 check against the acis xla step, the descent,
    and the step's collectives equal to the meta-device count."""
    from repro_torch import configs

    (rec,) = smoke.train_gspmd_path(configs.get_smoke("acis-100m"), 0,
                                    smoke.TRAIN_GSPMD_SMOKE, device="cpu")
    assert rec["phase"] == "train_gspmd" and rec["mesh"] == {
        "data": 2, "model": 2}
    assert rec["tp_plan"] == {"attention": True, "ffn": True}
    f32 = rec["f32_check"]
    assert max(f32["max_rel_diff"].values()) <= smoke.GSPMD_RTOL
    assert len(f32["same_state"]["grad_norm"]) == \
        smoke.TRAIN_GSPMD_SMOKE.checked
    assert f32["param_max_abs_diff"] <= smoke.GSPMD_PARAM_ATOL
    lr = smoke.TRAIN_GSPMD_SMOKE.check_lr
    for d in f32["same_state_params"]:
        assert d["max_abs_diff"] <= 2 * lr and d["atol"] == 1e-3 * lr
        assert d["min_leaf_share"] > smoke.GSPMD_CLOSE_SHARE
    assert rec["nll_last"] < rec["nll_first"] - smoke.TRAIN_GSPMD_SMOKE.bar
    assert rec["collectives"]["meta_count_equal"]
    kinds = rec["collectives"]["per_rank_bytes_by_kind"]
    assert set(kinds) == {"all-gather", "all-reduce", "reduce-scatter"}
    assert not any(rec["launches"].values())


def test_train_gspmd_phase_fails_on_copies_averaged(smoke, monkeypatch):
    """A replicated leaf whose copies' cotangents are averaged where they
    should be summed: AdamW's scale invariance keeps the nll and the
    params close, the grad_norm check catches it."""
    from repro_torch import configs
    from repro_torch.sharding import native

    def averaged(ctx, g):
        n = 1
        for a in ctx.axes:
            n *= ctx.mesh.axis_size(a)
        dims = native._rank_dims(ctx.mesh, ctx.axes)
        return native._sum_over(g, dims) / n, None, None

    monkeypatch.setattr(native._Replicate, "backward", staticmethod(averaged))
    with pytest.raises(AssertionError, match="train_gspmd: step 0 from "
                       "the same state: grad_norm"):
        smoke.train_gspmd_path(configs.get_smoke("acis-100m"), 0,
                               smoke.TRAIN_GSPMD_SMOKE, device="cpu")


def test_train_gspmd_sizes_at_full_width(smoke):
    """The card's phase: acis-100m (124,668,672 params) on the mesh of
    train_e2e's --backend xla, train_e2e's 8 x 256 traffic, 60 steps (cut
    from 100 for the run's time)."""
    from repro_torch import tree
    from repro_torch.configs.acis_100m import CONFIG
    from repro_torch.models import Model
    from repro_torch.train.step import tp_plan
    from repro_torch.launch.mesh import make_host_mesh

    g = smoke.TRAIN_GSPMD
    assert (g.data, g.model, g.batch, g.seq, g.steps) == (4, 2, 8, 256, 60)
    assert sum(p.numel() for p in tree.tree_leaves(
        Model(CONFIG).param_shapes())) == 124_668_672
    # 12 heads and 4 KV heads split over model = 2; d_ff 2048 too
    assert tp_plan(CONFIG, make_host_mesh(4, 2, device="meta")) == \
        (True, True)


def test_pipeline_path_rehearsed_on_the_cpu(smoke):
    from repro_torch import configs

    (rec,) = smoke.pipeline_path(configs.get_smoke("acis-100m"), 0,
                                 smoke.PIPELINE_SMOKE, device="cpu")
    assert rec["ticks"] == 3 + 2 - 1
    assert rec["f32"]["rel_err"] <= smoke.F32_REL
    assert rec["bf16"]["rel_err"] <= smoke.BF16_REL
    assert rec["int8"]["handoff_err_over_half_step"] <= 1
    assert rec["int8"]["stages_replayed"] == 3
    assert rec["int8"]["vs_identity_rel"] > 0
    p = smoke.PIPELINE
    assert p.microbatches + p.stages - 1 == 11
    assert 12 % p.stages == 0


def test_pipeline_phase_fails_on_a_dropped_handoff(smoke, monkeypatch):
    """A handoff that arrives as zeros breaks the IDENTITY check."""
    from repro_torch import configs
    from repro_torch.mesh import LocalMesh

    real = LocalMesh.shift

    def lossy(self, x, axis, k):
        return torch.zeros_like(real(self, x, axis, k))

    monkeypatch.setattr(LocalMesh, "shift", lossy)
    with pytest.raises(AssertionError, match="pipeline bf16"):
        smoke.pipeline_path(configs.get_smoke("acis-100m"), 0,
                            smoke.PIPELINE_SMOKE, device="cpu")


def test_seq_parallel_path_rehearsed_on_the_cpu(smoke):
    (rec,) = smoke.seq_parallel_path(0, smoke.SEQ_PARALLEL_SMOKE,
                                     device="cpu", expect_kernels=False)
    assert rec["sp_err_over_bound"] <= 1 and rec["whole_err_over_bound"] <= 1
    assert rec["steps_per_rank"] == 2048 // 8
    assert not any(rec["launches"].values())
    s = smoke.SEQ_PARALLEL
    # long_500k's length over 8 ranks at recurrentgemma-9b's lru_width:
    # 8.6 GB each for a and b
    assert (s.seq, s.width, s.seq // s.ranks) == (524288, 4096, 65536)
    assert s.batch * s.seq * s.width * 4 == 8_589_934_592


def test_seq_parallel_phase_fails_on_a_dropped_carry(smoke, monkeypatch):
    """Chunks joined without the rank scan's carry miss the bound."""
    from repro_torch.models import rglru as RG

    def no_carry(a, b, axis_name, **kw):
        return RG._affine_scan(a, b)

    monkeypatch.setattr(RG, "rglru_scan_sp", no_carry)
    with pytest.raises(AssertionError, match="sp_tolerance"):
        smoke.seq_parallel_path(0, smoke.SEQ_PARALLEL_SMOKE, device="cpu",
                                expect_kernels=False)


def test_dryrun_phase_rehearsed_on_the_cpu(smoke):
    """The dry-run processes start, run while the caller works, and their
    records come back; their directory is removed."""
    from pathlib import Path

    started = smoke.dryrun_start((("rwkv6-1.6b", "decode_32k", False),))
    recs = smoke.dryrun_finish(started, timeout=300)
    assert not Path(started["dir"]).exists()
    (rec,) = recs
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["t_compute_s"] > 0 and rec["useful_flops_ratio"] > 0
    assert rec["cell"] == ["rwkv6-1.6b", "decode_32k", False]
    assert smoke.DRYRUN_CELLS == (("qwen3-8b", "train_4k", False),
                                  ("qwen3-8b", "train_4k", True))
