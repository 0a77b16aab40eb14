"""The port's MoE family (GQA attention + routed and shared experts)
against the reference's.

* ``moe_ffn`` alone on f32 params: one token per sequence (decode: the
  capacity is the group, nothing drops) and a prompt at capacity factor 1
  (tokens drop): y within 1e-5 of its largest magnitude, the aux loss
  within 1e-6 relative.  Top-k ties go to the lower expert index, as
  ``jax.lax.top_k`` breaks them: equal router rows route every token to
  experts 0..k-1 in both packages, and ``top_k`` of tied values equals
  ``jax.lax.top_k``'s indices exactly.
* ``prefill`` (T decode steps, as the reference prefills a MoE stack) and
  decode on the qwen2-moe smoke config, and on a ``dataclasses.replace``
  with ``first_dense_layers=1``: the leading dense layer is the
  remainder and runs *before* the periods (``prefix_rem``), in decode
  and in the inference forward.  f32 params (bf16 routing flips at
  near-ties): logits within 1e-5 of their largest magnitude and 1e-5
  relative, caches within 1e-5, as ``test_torch_dense.py``.
* full-width param and cache trees of qwen2-moe-a2.7b (meta).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.models import moe as JMOE
from repro_torch import configs, interop, tree
from repro_torch.models import Model
from repro_torch.models import decode as TD
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from test_torch_dense import (_dt, _f32, _leaves_by_path, _run_port,
                              _run_reference, hold)

ARCH = "qwen2-moe-a2.7b"


@pytest.fixture(scope="module")
def moe():
    jm = JModel(jconfigs.get_smoke(ARCH))
    return jm, jm.init(jax.random.key(1)), Model(configs.get_smoke(ARCH))


@pytest.fixture(scope="module")
def moe_lead():
    """The smoke config with its first layer dense (the remainder)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), n_layers=3)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, first_dense_layers=1, d_ff_dense=64))
    cfg = dataclasses.replace(configs.get_smoke(ARCH), n_layers=3)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, first_dense_layers=1, d_ff_dense=64))
    jm = JModel(jcfg)
    return jm, jm.init(jax.random.key(2)), Model(cfg)


def _moe_params(cfg, key):
    return jax.tree.map(lambda p: p.astype(jnp.float32), JMOE.init_moe(
        jax.random.key(key), cfg.d_model, cfg.moe, cfg.activation))


@pytest.mark.parametrize("t,capacity_factor", [(1, 4.0), (6, 1.0)])
def test_moe_ffn_matches_the_reference(rng, t, capacity_factor):
    cfg = configs.get_smoke(ARCH)
    mcfg = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH).moe,
                               capacity_factor=capacity_factor)
    jp = _moe_params(cfg, 5)
    x = rng.standard_normal((3, t, cfg.d_model)).astype(np.float32)
    want, want_aux = jax.jit(lambda p, x: JMOE.moe_ffn(
        p, x, jcfg, cfg.activation))(jp, x)
    got, aux = TMOE.moe_ffn(interop.params_from_reference(jp),
                            torch.from_numpy(x), mcfg, cfg.activation)
    w = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), w, rtol=0,
                               atol=1e-5 * np.abs(w).max())
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    if t > 1:        # capacity 1 a group at factor 1: some tokens drop
        assert TMOE.capacity(mcfg, 3 * t, t) == 9


def test_top_k_breaks_ties_as_lax_top_k(rng):
    """Exact ties in every row: the lower index first, as lax.top_k."""
    x = rng.integers(0, 3, (64, 12)).astype(np.float32) / 4
    wv, wi = jax.lax.top_k(jnp.asarray(x), 5)
    gv, gi = TMOE.top_k(torch.from_numpy(x), 5)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(gv.numpy(), np.asarray(wv))


def test_tied_router_routes_to_the_lowest_experts(rng):
    """A zero router ties every expert: both packages send every token to
    experts 0..k-1 with equal weights, so y is those experts' mean plus
    the shared experts."""
    cfg = configs.get_smoke(ARCH)
    jp = _moe_params(cfg, 6)
    jp["router"] = jnp.zeros_like(jp["router"])
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    want, _ = JMOE.moe_ffn(jp, x, jconfigs.get_smoke(ARCH).moe,
                           cfg.activation)
    tp = interop.params_from_reference(jp)
    got, _ = TMOE.moe_ffn(tp, torch.from_numpy(x), cfg.moe, cfg.activation)
    w = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), w, rtol=0,
                               atol=1e-5 * np.abs(w).max())
    xe = torch.from_numpy(x).reshape(1, 2, cfg.d_model).expand(
        cfg.moe.n_experts, 2, cfg.d_model)
    ye = TMOE._expert_ffn(tp["experts"], xe, cfg.activation)
    shared = TMOE.L.ffn(tp["shared"], torch.from_numpy(x), cfg.activation)
    by_hand = ye[:cfg.moe.top_k].mean(0).reshape(2, 1, -1) + shared
    np.testing.assert_allclose(got.numpy(), by_hand.numpy(), rtol=0,
                               atol=1e-5 * np.abs(w).max())


def test_smoke_prefill_and_decode_match_the_reference(moe, rng):
    """f32 params: in bf16 the top-k routing is discontinuous, and a
    router probability one bf16 ulp from a tie sends a token to another
    expert in one package than in the other (the port rounds each op to
    bf16 where XLA's fusions keep f32)."""
    jm, jp, model = moe
    dtype = "float32"
    jp = _f32(jp)
    jdt = jnp.float32
    b, t = 3, 7
    toks = rng.integers(0, 512, (b, t)).astype(np.int32)
    nxt = [rng.integers(0, 512, (b,)).astype(np.int32) for _ in range(2)]
    want, want_c = _run_reference(jm, jp, toks, nxt,
                                  jm.init_cache(b, 16, dtype=jdt),
                                  lambda i: t + i)
    got, got_c = _run_port(model, interop.params_from_reference(jp), toks,
                           nxt, model.init_cache(b, 16,
                                                 getattr(torch, dtype),
                                                 device="cpu"),
                           lambda i: t + i)
    hold(got, want, got_c, want_c, dtype)


def test_leading_dense_layer_runs_first(moe_lead, rng):
    """``first_dense_layers=1``: the remainder (one dense_self layer) runs
    before the two moe_self periods in decode, prefill and forward, as
    the reference's ``prefix_rem`` orders it."""
    jm, jp, model = moe_lead
    jp = _f32(jp)
    assert TT._period_of(model.cfg) == (["moe_self"], 2, ["dense_self"])
    assert TT.rem_first(model.cfg)
    tp = interop.params_from_reference(jp)
    kinds = [k for _, _, k in TD._layers(tp, model.init_cache(
        1, 4, device="cpu"), model.cfg)]
    assert kinds == ["dense_self", "moe_self", "moe_self"]
    b, t = 2, 6
    toks = rng.integers(0, 512, (b, t)).astype(np.int32)
    nxt = [rng.integers(0, 512, (b,)).astype(np.int32) for _ in range(2)]
    want, want_c = _run_reference(jm, jp, toks, nxt,
                                  jm.init_cache(b, 12, dtype=jnp.float32),
                                  lambda i: t + i)
    got, got_c = _run_port(model, tp, toks, nxt,
                           model.init_cache(b, 12, torch.float32,
                                            device="cpu"), lambda i: t + i)
    hold(got, want, got_c, want_c, "float32")
    hidden, aux = jax.jit(jm.forward)(jp, jnp.asarray(toks))
    got_h, got_aux = TT.forward(tp, model.cfg, torch.from_numpy(toks))
    w = np.asarray(hidden)
    np.testing.assert_allclose(got_h.numpy(), w, rtol=0,
                               atol=1e-5 * np.abs(w).max())
    np.testing.assert_allclose(float(got_aux), float(aux), rtol=1e-5)


def test_other_families_keep_their_remainder_last():
    for name in ("recurrentgemma-9b", "qwen3-8b"):
        assert not TT.rem_first(configs.get(name))


def test_full_config_param_and_cache_trees_match_the_reference():
    jm = JModel(jconfigs.get(ARCH))
    model = Model(configs.get(ARCH))
    for want_t, got_t in (
            (jm.param_shapes(), model.param_shapes()),
            (jax.eval_shape(lambda: jm.init_cache(4, 32)),
             model.init_cache(4, 32, device="meta"))):
        want, got = _leaves_by_path(want_t), _leaves_by_path(got_t)
        assert list(got) == list(want)
        for k, leaf in got.items():
            assert tuple(leaf.shape) == tuple(want[k].shape), k
            assert _dt(leaf) == _dt(want[k]), k
    n = sum(x.numel() for x in tree.tree_leaves(model.param_shapes()))
    assert n == sum(int(np.prod(x.shape))
                    for x in jax.tree.leaves(jm.param_shapes()))


def test_moe_trees_cross_interop_both_ways(moe):
    jm, jp, _ = moe
    back = interop.params_to_reference(interop.params_from_reference(jp))
    want, got = _leaves_by_path(jp), _leaves_by_path(back)
    assert list(got) == list(want)
    assert "layers.pos0_moe_self.moe.experts.wi_gate" in got
    assert "layers.pos0_moe_self.moe.shared.wo" in got
    for k, w in want.items():
        assert _dt(got[k]) == _dt(w), k
        assert np.array_equal(np.asarray(got[k], np.float32),
                              np.asarray(w, np.float32)), k
