"""The ``moe`` family's part of the benchmark (DeepSeek-V2-Lite): its
configuration file against the published config and the program's
tree, its FLOP count by hand, and its reference and control at a tiny
size on the CPU."""

import json
import math

import pytest
import torch

from conftest import ROOT
from portbench.drivers import train_moe
from portbench.harness import manifest, runner, traffic, weights
from portbench.reference import moe as R

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CONF = next(c for c in MAN["configs"] if c["name"] == "deepseek-v2-lite")
CFG = json.loads((ROOT / CONF["file"]).read_text())
CELL = "deepseek-v2-lite.train-moe-4k"


def test_port_keys_restate_the_published_ones():
    """The published keys (HF's names) and the keys the program reads
    agree; the cut keys are the ones ``reduced`` lists."""
    c, m, a = CFG, CFG["moe"], CFG["mla"]
    assert CONF["reduced"] == ["num_hidden_layers", "n_routed_experts",
                               "vocab_size"]
    assert (c["num_hidden_layers"], c["n_routed_experts"],
            c["vocab_size"]) == (c["n_layers"], m["n_held"], c["vocab"])
    assert (c["n_layers"], m["n_held"], c["vocab"]) == (5, 8, 102400 // 8)
    assert c["router_experts"] == m["n_experts"] == 64
    pairs = [("hidden_size", c["d_model"]), ("num_attention_heads",
             c["n_heads"]), ("num_key_value_heads", c["n_kv_heads"]),
             ("intermediate_size", c["d_ff"]),
             ("moe_intermediate_size", m["d_ff_expert"]),
             ("num_experts_per_tok", m["top_k"]),
             ("n_shared_experts", m["n_shared"]),
             ("first_k_dense_replace", m["first_dense_layers"]),
             ("norm_topk_prob", m["norm_topk_prob"]),
             ("routed_scaling_factor", m["routed_scaling_factor"]),
             ("seq_aux", m["seq_aux"]), ("kv_lora_rank", a["kv_lora"]),
             ("qk_nope_head_dim", a["nope_head_dim"]),
             ("qk_rope_head_dim", a["rope_head_dim"]),
             ("v_head_dim", a["v_head_dim"]), ("rms_norm_eps", c["norm_eps"]),
             ("rope_theta", c["rope_theta"])]
    for key, port in pairs:
        assert c[key] == port, key
    assert c["q_lora_rank"] is None and a["q_lora"] == 0
    assert m["d_ff_shared"] == c["n_shared_experts"] \
        * c["moe_intermediate_size"]
    y, rs = a["yarn"], c["rope_scaling"]
    assert (y["factor"], y["original_max"], y["beta_fast"], y["beta_slow"],
            y["mscale"], y["mscale_all_dim"]) == (
        rs["factor"], rs["original_max_position_embeddings"],
        rs["beta_fast"], rs["beta_slow"], rs["mscale"], rs["mscale_all_dim"])
    assert c["max_seq"] == rs["original_max_position_embeddings"]


def test_spec_equals_the_programs_tree():
    """The benchmark's layout of the configuration, leaf for leaf, is the
    program's (on the meta device), and its size is the cut's."""
    from repro_torch.models import Model

    spec = R.param_spec(CFG)
    model = Model(train_moe.program_config(CFG))
    got = weights.paths_of(model.param_shapes())
    assert set(got) == {x.path for x in spec}
    for x in spec:
        assert tuple(got[x.path].shape) == x.shape, x.path
        assert got[x.path].dtype == x.dtype, x.path
    n = {x.path: math.prod(x.shape) for x in spec}
    assert sum(n.values()) == 535_060_992
    assert n["embed"] + n["lm_head"] == 52_428_800
    dense = sum(v for k, v in n.items() if k.startswith(R.DENSE))
    moe = sum(v for k, v in n.items() if k.startswith(R.MOE)) // 4
    assert (round(dense / 1e6, 1), round(moe / 1e6, 1)) == (81.0, 100.4)


TINY = {"family": "moe", "n_layers": 2, "d_model": 8, "n_heads": 2,
        "vocab": 10, "d_ff": 6, "mla": {"kv_lora": 4, "rope_head_dim": 2,
                                        "nope_head_dim": 4, "v_head_dim": 3},
        "moe": {"n_experts": 8, "n_held": 2, "top_k": 2, "d_ff_expert": 5,
                "d_ff_shared": 7}}


def test_forward_flops_by_hand():
    # a token's MACs in each layer's attention: q 8x(2x6) = 96, dkv 8x6
    # = 48, uk and uv 4x(2x4) + 4x(2x3) = 56, o 6x8 = 48 -> 248;
    # the dense FFN 3 x 8 x 6 = 144, logits 8 x 10 = 80; the MoE layer's
    # shared FFN 3 x 8 x 7 = 168 and router 8 x 8 = 64; over 3 tokens:
    macs = 3 * (2 * 248 + 144 + 80 + 168 + 64)
    # attention: 6 causal pairs a head, 2 heads, (6 + 3) MACs a pair, 2
    # layers; held experts: 3 tokens x 2 choices x 2/8 held, 3 x 8 x 5
    flops = 2 * macs + 2 * 6 * 2 * 2 * 9
    flops += 3 * 2 * 2 * 2 * 3 * 8 * 5 // 8
    assert train_moe.forward_flops(TINY, 3) == flops
    assert train_moe.train_step_flops(TINY, 4, 3) == 12 * flops
    # counted pairs in the uniform share's place: 1.5 a row and layer
    counted = flops - 3 * 2 * 2 * 2 * 3 * 8 * 5 // 8 + 1.5 * 2 * 3 * 8 * 5
    assert train_moe.forward_flops(TINY, 3, 1.5) == counted
    assert train_moe.train_step_flops(TINY, 4, 3, 1.5) == 12 * counted


def test_routed_pairs_a_row_from_the_second_pass():
    """The pass's count over its route spans (forward and recompute) and
    the step's rows; nothing counted gives None."""
    spans = [["acis.moe.route", 0, 1, None]] * 4 \
        + [["acis.moe.combine", 1, 2, None]]
    prog = {"spans": spans, "counters": {"moe.routed_pairs": 96.0}}
    assert train_moe.routed_per_row(prog, 8) == 3.0
    assert train_moe.routed_per_row(dict(prog, counters={}), 8) is None
    assert train_moe.routed_per_row(dict(prog, spans=spans[4:]), 8) is None


def test_reference_runs_at_a_tiny_size():
    """The reference's loss at tiny widths: finite, and the same for
    the same seed; its gradient reaches every held leaf."""
    cfg = dict(TINY, param_dtype="float32", norm_eps=1e-6,
               rope_theta=1e4, z_loss=1e-4)
    cfg["moe"] = dict(TINY["moe"], first_held=2, norm_topk_prob=False,
                      routed_scaling_factor=1.0, router_aux_weight=1e-3)
    W = weights.draw(R.param_spec(cfg), 5, "cpu")
    tokens = torch.randint(0, 10, (3, 9),
                           generator=torch.Generator().manual_seed(6))
    job = {"ranks": 3, "optimizer": {"lr": 1e-3, "b1": 0.9, "b2": 0.95,
                                     "eps": 1e-8, "weight_decay": 0.1}}
    a = R.reference_steps(cfg, job, W, [{"tokens": tokens}] * 2)
    b = R.reference_steps(cfg, job, W, [{"tokens": tokens}] * 2)
    assert a["loss"] == b["loss"] and all(map(math.isfinite, a["loss"]))
    assert a["loss"][1] < a["loss"][0]
    assert all(v > 0 for v in a["grad_norms"].values())


def test_control_comes_out_not_correct(small, monkeypatch):
    """The reference in float8 put in the program's place, through this
    cell's own driver: its readings are what the run compares."""
    def setup(self):
        ranks = [None] * self.job["ranks"]

        def keep(r, grads):
            ranks[r] = grads
        self.readings = dict(self.reference(precision="fp8", per_rank=keep),
                             rank_grads=ranks)
        self.pool = traffic.train_pool(self.cfg, self.job, self.seed,
                                       self.device)
    monkeypatch.setattr(train_moe.Cell, "setup", setup)
    monkeypatch.setattr(train_moe.Cell, "window", lambda self, s, spans:
                        {"attempted": 1, "seconds": s, "end_to_end": {
                            "train_tokens_per_s": 1.0}})
    monkeypatch.setattr(manifest, "driver", lambda name, bench=None:
                        train_moe)
    cell = manifest.cell(CELL, small)
    out = runner.run_cell(cell, 2 ** 33 + 5, 0.2, False, device="cpu")[0]
    assert not out["correct"], out["check"]


def test_rows_are_capped_at_the_trained_context(small):
    cell = manifest.cell(CELL, small)
    run = train_moe.Cell(cell, 1, "cpu")
    assert run.job["seq"] == min(cell.job["seq"], cell.cfg["max_seq"])
    assert manifest.cell(CELL).job["seq"] == 4096 == CFG["max_seq"]


@pytest.mark.parametrize("name", ["mla_attention_ms.train",
                                  "moe_route_ms.train", "moe_experts_ms.train",
                                  "mla_flash_roofline.train"])
def test_new_readers_give_none_without_the_program(name):
    assert manifest.metric_reader(name)({"window": {}, "trace": None,
                                         "device_kind": "cpu"}) is None
