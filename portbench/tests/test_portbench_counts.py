"""The yardstick's arithmetic against hand-worked cases: FLOPs, bytes,
peaks, the trace's union and idle gaps, the percentile; the weights and
traffic the benchmark draws."""

import json

import pytest
import torch

from conftest import ROOT
from portbench.drivers.sync import p95
from portbench.harness import counts, traffic, weights
from portbench.harness.trace import idle_gaps_by_host_op, union_us
from portbench.reference.spec import param_count, param_spec, tree_bytes

TINY_DENSE = {"family": "dense", "n_layers": 1, "d_model": 4, "n_heads": 2,
              "n_kv_heads": 1, "d_ff": 8, "vocab": 10,
              "activation": "swiglu", "norm": "rms",
              "param_dtype": "bfloat16"}
TINY_ENCDEC = {"family": "encdec", "n_layers": 1, "d_model": 4,
               "n_heads": 2, "n_kv_heads": 2, "d_ff": 8, "vocab": 10,
               "activation": "gelu", "norm": "layer", "max_seq": 7,
               "param_dtype": "bfloat16",
               "encdec": {"n_encoder_layers": 1, "encoder_seq": 5}}


def test_dense_forward_flops_by_hand():
    # a token's MACs: q 4x4, k 4x2, v 4x2, o 4x4 = 48; gate and up 4x8
    # each, down 8x4 = 96; logits 4x10 = 40 -> 184, x 3 tokens x 2 = 1104.
    # causal attention: 1 + 2 + 3 = 6 pairs, scores and weighted sum each
    # a 4-wide dot product over both heads: 6 x 8 MACs x 2 = 96
    assert counts.forward_flops(TINY_DENSE, 3) == 1104 + 96
    assert counts.train_step_flops(TINY_DENSE, 5, 3) == 3 * 5 * 1200


def test_encdec_forward_flops_by_hand():
    # decoder token: self q,k,v,o 4x4 each = 64, FFN 4x8 + 8x4 = 64,
    # logits 40, cross q and o 4x4 each = 32 -> 200 MACs x 3 tokens;
    # encoder token: 64 + 64 = 128 MACs x 5 frames; cross k and v over
    # the 5 encoder outputs: 2 x 16 MACs x 5 = 160
    macs = 200 * 3 + 128 * 5 + 160
    # attention: causal self 6 pairs, encoder 25 pairs, cross 3 x 5 = 15
    # pairs; each pair 4 + 4 MACs
    macs += (6 + 25 + 15) * 8
    assert counts.forward_flops(TINY_ENCDEC, 3) == 2 * macs


def test_published_parameter_counts():
    cfgs = {c["name"]: json.loads((ROOT / c["file"]).read_text())
            for c in json.loads((ROOT / "BENCHMARK.json").read_text())
            ["configs"]}
    # whisper-small's head is tied to its token embedding and its text
    # context is 448 positions
    assert param_count(cfgs["whisper-small"]) == 239_604_480
    assert param_count(cfgs["acis-100m"]) == 124_668_672
    assert len(param_spec(cfgs["whisper-small"])) == 33
    assert "lm_head" not in {x.path for x in param_spec(cfgs["whisper-small"])}


def test_sync_least_bytes():
    spec = param_spec(TINY_DENSE)
    numel = sum(torch.Size(x.shape).numel() for x in spec)
    f32 = sum(torch.Size(x.shape).numel() for x in spec
              if x.dtype == torch.float32)
    assert tree_bytes(TINY_DENSE) == 2 * (numel - f32) + 4 * f32
    assert counts.sync_least_bytes(TINY_DENSE, 8) == 16 * tree_bytes(
        TINY_DENSE)
    assert counts.sync_least_bytes(TINY_DENSE, 8, residual=True) == \
        16 * tree_bytes(TINY_DENSE) + 16 * 4 * numel


def test_peaks():
    assert counts.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert counts.peaks("NVIDIA H100 PCIe") == (756e12, 2.0e12)
    with pytest.raises(KeyError):
        counts.peaks("a card with no data sheet")


def test_union_and_idle_gaps():
    total, merged = union_us([(5, 6), (0, 2), (1, 3), (10, 11)])
    assert total == 5 and merged == [[0, 3], [5, 6], [10, 11]]
    host = [(0, 9, "outer"), (3.5, 4.5, "aten::inner"), (7, 7.5, "early")]
    gaps = idle_gaps_by_host_op(merged, host)
    assert gaps == {"aten::inner": 2e-6, "outer": 4e-6}


def test_p95_nearest_rank():
    assert p95(list(range(1, 101))) == 95
    assert p95([3.0]) == 3.0


def test_weights_and_traffic_follow_the_seed():
    spec = param_spec(TINY_DENSE)
    a = weights.draw(spec, 2 ** 40 + 7, "cpu")
    b = weights.draw(spec, 2 ** 40 + 7, "cpu")
    c = weights.draw(spec, 2 ** 40 + 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert a["final_norm.scale"].dtype == torch.float32
    assert a["lm_head"].dtype == torch.bfloat16
    t1 = traffic.bigram_tokens(50, 16, 9, 3_000_000_001, "cpu")
    t2 = traffic.bigram_tokens(50, 16, 9, 3_000_000_001, "cpu")
    assert torch.equal(t1, t2) and t1.shape == (16, 9)
    assert len({tuple(r) for r in t1.tolist()}) == 16
    assert int(t1.min()) >= 0 and int(t1.max()) < 50


def test_nest_holds_the_program_layout():
    spec = param_spec(TINY_DENSE)
    flat = weights.draw(spec, 1, "cpu")
    layout = {"embed": flat["embed"], "lm_head": flat["lm_head"],
              "final_norm": {"scale": flat["final_norm.scale"]},
              "layers": {"pos0_self": {}}, "rem": {}}
    with pytest.raises(ValueError):
        weights.nest(flat, layout)
    only = {k: v for k, v in flat.items() if k in
            ("embed", "lm_head", "final_norm.scale")}
    tree = weights.nest(only, layout)
    assert tree["rem"] == {} and tree["embed"] is only["embed"]
    bad = dict(only, embed=only["embed"].float())
    with pytest.raises(ValueError):
        weights.nest(bad, layout)
