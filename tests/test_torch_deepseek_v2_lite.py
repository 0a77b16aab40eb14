"""DeepSeek-V2-Lite on the port (``configs/deepseek_v2_lite.py``) against
the plain reference of the benchmark (``portbench/reference/moe.py``),
which imports neither JAX nor a kernel of the port.

On the CPU, float32, seeded random weights at the SMOKE size:

* the forward loss and every rank's gradients through the train step's
  ``local_grads`` on ``LocalMesh({"data": 2})``, and one whole step
  (the ``acis`` sync, AdamW), against the reference's ranks, mean and
  AdamW;
* the expert-parallel share: the outputs of the 8 shares of one MoE
  layer, the shared experts counted once, add up to the reference's
  uncut layer;
* the dropless grouped dispatch equals the capacity path where nothing
  drops;
* latent attention's per-head form (the one the card trains in) equals
  the absorbed form;
* YaRN's frequencies and softmax scale against the published closed
  form.

Tolerances: 1e-5 of the largest magnitude for one layer (the same f32
values summed in another order), 1e-4 for a whole model's loss and
gradients (two layers, the softmax and the loss add orders of their
own).  On the card (``cuda`` mark, skips here): a MoE layer's forward
and backward read no routing count on the host.
"""

import dataclasses
import math

import pytest
import torch

from portbench.harness import weights
from portbench.reference import moe as R
from portbench.reference.model import matmul
from repro_torch import configs
from repro_torch.configs import deepseek_v2_lite as DSV2
from repro_torch.core import make_engine
from repro_torch.mesh import LocalMesh
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.train import step as S
from repro_torch.train.optimizer import adamw

OPT = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _cfg(**moe):
    c = DSV2.SMOKE
    return dataclasses.replace(c, param_dtype="float32", dtype="float32",
                               moe=dataclasses.replace(c.moe, **moe))


def _ref_cfg(cfg) -> dict:
    """The reference's JSON form of a port config."""
    out = dataclasses.asdict(cfg)
    out["moe"]["n_held"] = cfg.moe.held
    out["z_loss"] = 1e-4
    return out


def _close(got, want, rel):
    got, want = got.double(), want.double()
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), (err, want.abs().max())


def _setup(cfg, seed=3):
    rc = _ref_cfg(cfg)
    flat = weights.draw(R.param_spec(rc), seed, "cpu")
    model = Model(cfg)
    return model, weights.nest(flat, model.param_shapes()), flat, rc


def _tokens(cfg, rows, t, seed=4):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (rows, t + 1), generator=g)


@pytest.mark.parametrize("held", [(0, 0), (4, 8)], ids=["all", "share"])
def test_loss_and_rank_grads_match_the_reference(held):
    n_held, first = held
    cfg = _cfg(n_held=n_held, first_held=first)
    model, params, flat, rc = _setup(cfg)
    mesh = LocalMesh({"data": 2}, device="cpu")
    tokens = _tokens(cfg, 4, 12)
    opt = adamw(**OPT)
    state = S.TrainState(params, opt.init(params),
                         torch.zeros((), dtype=torch.int32))
    grads, metrics = S.local_grads(model, state, {"tokens": tokens}, mesh)
    got_loss = metrics["nll"] + metrics["z_loss"] + metrics["aux"]

    ranks = {}
    job = {"ranks": 2, "optimizer": OPT}
    want = R.reference_steps(rc, job, flat, [{"tokens": tokens}],
                             per_rank=lambda r, g: ranks.__setitem__(r, g))
    mm = matmul("float32")
    for r in range(2):
        ref_loss = R.row_losses(flat, rc, tokens[2 * r:2 * r + 2], mm).mean()
        assert abs(float(got_loss[r]) - float(ref_loss)) <= 1e-5 * abs(
            float(ref_loss))
    assert abs(float(got_loss.mean()) - want["loss"][0]) <= 1e-5 * abs(
        want["loss"][0])
    got = weights.paths_of(grads)
    assert set(got) == set(ranks[0])
    for r in range(2):
        for k, g in ranks[r].items():
            _close(got[k][r], g, 1e-4)

    # one whole step: the acis mean over the ranks, then AdamW
    engine = make_engine("acis")
    step = S.build_train_step_acis(model, opt, mesh, engine)
    new, _ = step(S.TrainState(params, opt.init(params),
                               torch.zeros((), dtype=torch.int32),
                               engine.init_state(S.grads_like(params, mesh))),
                  {"tokens": tokens})
    after = weights.paths_of(new.params)
    for k, norm in want["update_norms"].items():
        moved = float(torch.linalg.vector_norm(after[k] - flat[k]))
        assert abs(moved - norm) <= 1e-3 * max(norm, 1e-6), k


@pytest.mark.parametrize("lead", [(), (2,)], ids=["plain", "rank_dims"])
def test_shares_add_up_to_the_uncut_layer(lead):
    """Eight shares of 2 of the 16 experts each, the shared experts
    counted once, against the reference's layer with every expert."""
    cfg = _cfg()
    assert cfg.moe.n_experts == 16
    g = torch.Generator().manual_seed(7)
    p = MOE.init_moe(g, cfg.d_model, cfg.moe, cfg.activation, torch.float32)
    x = torch.randn(lead + (3, 10, cfg.d_model), generator=g)
    whole_p = {k: (v.expand(lead + v.shape) if torch.is_tensor(v) else
                   {n: w.expand(lead + w.shape) for n, w in v.items()})
               for k, v in p.items()}
    total = 0
    for s in range(8):
        share = dataclasses.replace(cfg.moe, n_held=2, first_held=2 * s)
        ps = dict(whole_p, experts={n: w[..., 2 * s:2 * s + 2, :, :]
                                    for n, w in whole_p["experts"].items()})
        total = total + MOE.moe_ffn(ps, x, share, cfg.activation)[0]
    shared = L.ffn(whole_p["shared"], x, cfg.activation)
    got = total - 7 * shared

    rc = _ref_cfg(cfg)
    W = {"m.router": p["router"],
         **{f"m.experts.{n}": w for n, w in p["experts"].items()},
         **{f"m.shared.{n}": w for n, w in p["shared"].items()}}
    mm = matmul("float32")
    flat = x.reshape((-1,) + x.shape[-2:])
    want, want_aux = R.moe(W, "m", lambda t: t, flat, rc, mm)
    _close(got.reshape(want.shape), want, 1e-5)
    whole, aux = MOE.moe_ffn(whole_p, x, cfg.moe, cfg.activation)
    _close(whole.reshape(want.shape), want, 1e-5)
    # the balance loss: the mean over a rank's rows of the reference's
    _close(aux.reshape(-1), want_aux.reshape(lead + (3,)).mean(-1)
           .reshape(-1), 1e-5)


@pytest.mark.parametrize("norm,scale", [(False, 1.0), (False, 2.5),
                                        (True, 0.5)])
def test_routing_options_match_the_reference(norm, scale):
    """``norm_topk_prob`` and ``routed_scaling_factor`` off and on, the
    layer against the reference's, output and balance loss."""
    cfg = _cfg(norm_topk_prob=norm, routed_scaling_factor=scale)
    g = torch.Generator().manual_seed(11)
    p = MOE.init_moe(g, cfg.d_model, cfg.moe, cfg.activation, torch.float32)
    x = torch.randn(3, 10, cfg.d_model, generator=g)
    W = {"m.router": p["router"],
         **{f"m.experts.{n}": w for n, w in p["experts"].items()},
         **{f"m.shared.{n}": w for n, w in p["shared"].items()}}
    want, want_aux = R.moe(W, "m", lambda t: t, x, _ref_cfg(cfg),
                           matmul("float32"))
    got, aux = MOE.moe_ffn(p, x, cfg.moe, cfg.activation)
    _close(got, want, 1e-5)
    _close(aux.reshape(1), want_aux.mean().reshape(1), 1e-5)


PORT_FIELDS = [("moe", "n_held", 4), ("moe", "first_held", 4),
               ("moe", "norm_topk_prob", False),
               ("moe", "routed_scaling_factor", 2.5),
               ("moe", "dropless", True), ("moe", "seq_aux", True),
               ("mla", "yarn", DSV2.YARN)]


@pytest.mark.parametrize("group,field,value", PORT_FIELDS,
                         ids=[f for _, f, _ in PORT_FIELDS])
def test_a_port_field_off_its_default_shows_in_the_repr(group, field,
                                                        value):
    """The repr a config shares with the reference's leaves out the
    port's own fields only while they hold their default, so a config
    that the parity tests hold to the reference cannot turn one on
    unseen."""
    cfg = configs.get("deepseek-v2-236b")
    changed = dataclasses.replace(cfg, **{group: dataclasses.replace(
        getattr(cfg, group), **{field: value})})
    assert f"{field}=" not in repr(cfg)
    assert f"{field}={value!r}" in repr(changed)


@pytest.mark.parametrize("norm,seq_aux", [(True, False), (False, True)])
def test_dropless_equals_capacity_where_nothing_drops(norm, seq_aux):
    base = _cfg(norm_topk_prob=norm, seq_aux=seq_aux)
    cap = dataclasses.replace(base.moe, dropless=False,
                              capacity_factor=float(base.moe.n_experts))
    g = torch.Generator().manual_seed(8)
    p = MOE.init_moe(g, base.d_model, base.moe, base.activation,
                     torch.float32)
    x = torch.randn(2, 3, 9, base.d_model, generator=g, requires_grad=True)
    y0, a0 = MOE.moe_ffn(p, x, cap, base.activation)
    y1, a1 = MOE.moe_ffn(p, x, base.moe, base.activation)
    _close(y1, y0, 1e-5)
    _close(a1, a0, 1e-6)
    g0 = torch.autograd.grad((y0.square().sum() + a0.sum()), x)[0]
    g1 = torch.autograd.grad((y1.square().sum() + a1.sum()), x)[0]
    _close(g1, g0, 1e-5)


def test_per_head_and_absorbed_forms_agree():
    cfg = _cfg()
    g = torch.Generator().manual_seed(9)
    p = MLA.init_mla(g, cfg.d_model, cfg.n_heads, cfg.mla, torch.float32)
    x = torch.randn(2, 13, cfg.d_model, generator=g)
    pos = torch.arange(13)[None]
    q_nope, q_rope = MLA._queries(p, x, cfg.n_heads, cfg.mla, pos, 1e4)
    c_kv, k_rope = MLA._latents(p, x, cfg.mla, pos, 1e4)
    absorbed = MLA._attend(p, q_nope, q_rope, c_kv, k_rope, cfg.n_heads,
                           cfg.mla, causal=True, q_offset=0, chunk=4)
    per_head = MLA._attend_per_head(p, q_nope, q_rope, c_kv, k_rope,
                                    cfg.n_heads, cfg.mla, q_offset=0,
                                    chunk=4)
    _close(per_head, absorbed, 1e-5)
    assert not MLA.per_head(x, cfg.mla, 0)      # the CPU keeps absorbed
    # and the layer against the reference's per-head MLA
    rc = _ref_cfg(cfg)
    W = {f"a.{k}": v for k, v in weights.paths_of(p).items()}
    want = R.mla(W, "a", lambda t: t, x, rc, matmul("float32"))
    _close(MLA.mla_attention(p, x, n_heads=cfg.n_heads, cfg=cfg.mla,
                             chunk=4), want, 1e-5)


def _correction_dim(rot, dim, base, max_pos):
    return (dim * math.log(max_pos / (rot * 2 * math.pi))) \
        / (2 * math.log(base))


def test_yarn_frequencies_and_scale_match_the_closed_form():
    """``DeepseekV2YarnRotaryEmbedding`` and the softmax scale of
    ``DeepseekV2Attention``, written out at V2-Lite's settings."""
    m = DSV2.CONFIG.mla
    y = m.yarn
    dim, base = m.rope_head_dim, 10000.0
    low = max(math.floor(_correction_dim(y.beta_fast, dim, base,
                                         y.original_max)), 0)
    high = min(math.ceil(_correction_dim(y.beta_slow, dim, base,
                                         y.original_max)), dim - 1)
    assert (low, high) == (10, 23)
    mask = 1.0 - ((torch.arange(dim // 2, dtype=torch.float64) - low)
                  / (high - low)).clamp(0, 1)
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64)
                           / dim)
    inter = 1.0 / (y.factor * base ** (torch.arange(0, dim, 2,
                                                    dtype=torch.float64)
                                       / dim))
    want = inter * (1 - mask) + extra * mask
    got = MLA.rope_frequencies(m, base)
    assert torch.allclose(got.double(), want, rtol=1e-6, atol=0)
    ref = R.rope_frequencies({"rope_theta": base,
                              "mla": dataclasses.asdict(m)}, "cpu")
    assert torch.allclose(ref.double(), want, rtol=1e-6, atol=0)
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert abs(mscale - 1.2608) < 1e-4
    assert math.isclose(MLA.softmax_scale(m), 192 ** -0.5 * mscale ** 2,
                        rel_tol=1e-12)
    assert MLA.rope_mscale(y) == 1.0
    # without YaRN: RoPE's frequencies and 1/sqrt(192)
    plain = dataclasses.replace(m, yarn=None)
    assert torch.equal(MLA.rope_frequencies(plain, base),
                       L.rope_frequencies(dim, base))
    assert MLA.softmax_scale(plain) == 1 / math.sqrt(192)


def test_published_config_on_meta():
    """CONFIG at its published widths: 64 experts of 1,408, 2 shared,
    the dense first layer of 10,944, MLA 512 / 128 / 64 / 128, and its
    parameter count (15.7B in the published model card)."""
    cfg = DSV2.CONFIG
    shapes = weights.paths_of(Model(cfg).param_shapes())
    n = sum(v.numel() for v in shapes.values())
    assert 15.6e9 < n < 15.8e9
    assert shapes["layers.pos0_moe_self.moe.experts.wi_gate"].shape == \
        (26, 64, 2048, 1408)
    assert shapes["layers.pos0_moe_self.moe.router"].shape == (26, 2048, 64)
    assert shapes["rem.rem0_dense_self.ffn.wi_up"].shape == (2048, 10944)
    assert shapes["layers.pos0_moe_self.attn.wq"].shape == (26, 2048,
                                                            16 * 192)


@pytest.mark.cuda
def test_a_moe_layer_reads_no_count_on_the_host_on_card():
    """Forward and backward of the dropless layer at a chip's share with
    CUDA's sync check raising on any wait for the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the grouped products run on the "
                    "card")
    cfg = dataclasses.replace(DSV2.CONFIG.moe, n_held=8)
    g = torch.Generator(device="cuda").manual_seed(10)
    p = MOE.init_moe(g, 2048, cfg, "swiglu", torch.bfloat16, device="cuda",
                     lead=(2,))
    x = torch.randn(2, 2, 512, 2048, device="cuda", dtype=torch.bfloat16,
                    generator=g, requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = MOE.moe_ffn(p, x, cfg, "swiglu")
        gx, = torch.autograd.grad(y.float().square().sum() + aux.sum(), x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(gx).all()


def test_spans_and_counters_while_recorded():
    """Under the span log: ``mla.attention``, ``moe.route``,
    ``moe.experts`` and ``moe.combine``, the pairs sent to held experts
    (a device count, a number once the recording closes) and no dropped
    pair; without it, nothing is recorded."""
    from repro_torch import obs

    cfg = _cfg(n_held=4, first_held=4)
    model, params, _, _ = _setup(cfg)
    tokens = _tokens(cfg, 2, 10)
    with obs.recording(spans=True) as rec:
        model.forward(params, tokens[:, :-1])
    names = [s.name for s in rec.spans]
    assert names.count("mla.attention") == cfg.n_layers
    for n in ("moe.route", "moe.experts", "moe.combine"):
        assert names.count(n) == cfg.n_layers - 1
    routed = rec.counter("moe.routed_pairs")
    assert isinstance(routed, (int, float)) and 0 < routed <= 2 * 10 * 3
    assert rec.counter("moe.dropped_pairs") == 0
    with obs.recording() as rec:
        model.forward(params, tokens[:, :-1])
    assert rec.counters == {}
