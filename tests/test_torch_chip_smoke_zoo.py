"""``chip_smoke.py``'s phases of the MLA, encdec and vlm families
(``serve_mla``, ``serve_encdec``, ``serve_vlm``, ``train_encdec``),
rehearsed on the CPU at the smoke configs.

On the CPU every kernel wrapper runs its plain version and launches
nothing, so the rehearsal shows the phases run their paths and pass the
script's own checks, and that the vlm phase's context check catches a
cross attention that reads nothing.  The card runs the same code at full
width (a file of its own beside ``test_torch_chip_smoke.py``, so the two
rehearsals run on separate workers).
"""

import pytest

import zoo_parity as Z


@pytest.fixture(scope="module")
def smoke():
    yield from Z.chip_smoke_module()


@pytest.mark.parametrize("name,phase", [
    ("deepseek-v2-236b", "serve_mla"), ("whisper-small", "serve_encdec"),
    ("llama-3.2-vision-11b", "serve_vlm")])
def test_zoo_serve_path_rehearsed_on_the_cpu(smoke, name, phase):
    """serve_mla, serve_encdec and serve_vlm at the smoke configs: forward
    against prefill + decode in bf16 and f32, the second context, the
    re-encoding timings, the MLA checks and engine; no kernel launched
    (none is on these paths)."""
    from repro_torch import configs

    mla = phase == "serve_mla"
    sizes = smoke.SERVE_MLA_SMOKE if mla else smoke.SERVE_ZOO_SMOKE
    recs = smoke.zoo_serve_path(configs.get_smoke(name), 0, sizes,
                                device="cpu", phase=phase)
    pre = recs[0]
    assert [r["program"] for r in recs] == ["prefill_decode"] \
        + ["engine", "engine_f32"] * mla
    assert pre["prefill_vs_decode"]["logit_err_over_bound"] <= 1
    assert pre["f32_check"]["prefill_vs_decode"]["logit_err_over_bound"] <= 1
    assert pre["f32_check"]["prefill_vs_decode"]["tokens_compared"] > 0
    for r in recs:
        assert r["phase"] == phase and not any(r["launches"].values())
    if mla:
        assert pre["layers"] == 3 and pre["f32_check"]["layers"] == 2
        assert pre["mla"]["absorbed_vs_materialized_rel"] <= smoke.F32_REL
        # a random bf16 model's greedy tokens sit at near-ties, so the
        # fresh engines compare few; the f32 engine compares them
        assert recs[1]["generated_tokens"] == 12
        assert recs[2]["fresh_engine_tokens_compared"] > 0
        assert "context" not in pre
    else:
        assert pre["context_b_vs_a_rel"] > smoke.BF16_REL
    if phase == "serve_encdec":
        enc = pre["encode"]
        assert len(enc["step_ms"]["reencoded"]) == sizes.timed_steps
    else:
        assert "encode" not in pre
    assert ("gates" in pre) == (phase == "serve_vlm")


@pytest.mark.parametrize("fault", ["gates_at_zero", "context_dropped"])
def test_vlm_phase_fails_without_its_cross_attention(smoke, monkeypatch,
                                                     fault):
    """The context check is tight: with the cross gates left at their
    initial 0, or with the context never reaching the model, the logits
    do not move with the context and the phase fails."""
    from repro_torch import configs
    from repro_torch.models import model as M

    if fault == "gates_at_zero":
        monkeypatch.setattr(smoke, "draw_gates_", lambda params, gen: [])
    else:
        monkeypatch.setattr(M.Model, "_context", lambda self, p, c: None)
    with pytest.raises(AssertionError, match="context is not read"):
        smoke.zoo_serve_path(configs.get_smoke("llama-3.2-vision-11b"), 0,
                             smoke.SERVE_ZOO_SMOKE, device="cpu",
                             phase="serve_vlm")


def test_train_encdec_path_rehearsed_on_the_cpu(smoke):
    """train_encdec at the whisper smoke config: the step check on acis
    and int8_hopquant with the context split over 8 ranks, then the
    descent."""
    from repro_torch import configs

    recs = smoke.train_encdec_path(configs.get_smoke("whisper-small"), 0,
                                   smoke.TRAIN_ENCDEC_SMOKE, device="cpu",
                                   expect_kernels=False)
    assert [(r["program"], r["backend"]) for r in recs] == [
        ("sync_check", "acis"), ("sync_check", "acis_compressed"),
        ("descent", "acis")]
    assert all(r["phase"] == "train_encdec" for r in recs)
    assert recs[0]["launches_per_sync"]["fused_hop"] > 0
    assert recs[1]["launches_per_sync"]["quant_hop"] > 0
    for r in recs[:2]:
        assert r["bitwise_equal_to_plain"]
    d = recs[-1]
    assert len(d["curve"]) == smoke.TRAIN_ENCDEC_SMOKE.e2e_steps
    assert d["nll_last"] < d["nll_first"]
    assert d["context"] == [8, 16, 64]
    assert all(not any(r["launches"].values()) for r in recs)
