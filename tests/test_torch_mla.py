"""MLA attention (deepseek-v2) against the reference.

* The deepseek-v2 smoke model (1 dense + 1 MoE layer, both MLA) through
  the shared checks of ``tests/zoo_parity.py``: forward, prefill and
  decode with a scalar and a per-row index (logits and the latent cache
  leaves), the train step's per-rank gradients, the full config's trees
  on the meta device.
* ``mla_attention`` and ``mla_decode`` without a query LoRA (the ``wq``
  form, which the configs do not use) against the reference's functions,
  f32 within 1e-5 of the largest magnitude.
* The absorbed-projection attention against attention over per-head keys
  and values materialized from the latents (``W_uk c``, ``W_uv c``), f32
  within 1e-5: the trick's algebra, its softmax scale 1/sqrt(nope +
  rope) included.  The oracle is ``chip_smoke.materialized_mla``, the
  one the card's ``serve_mla`` phase holds the full width against.
* The latent cache: 576 values a token and layer at full width against
  2·128·128 for a 128-head KV cache, the reference's 57×.
* ``ServeEngine(slots=2)`` over the smoke model (f32-cast params, so
  greedy tokens compare the engines and not bf16 near-ties) against the
  reference's engine: the same completions, a reused slot included.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoo_parity as Z
from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.models import mla as JMLA
from repro.obs import metrics as jobs
from repro.serve import engine as J
from repro_torch import configs, interop
from repro_torch.models import Model
from repro_torch.models import mla as TMLA
from repro_torch.obs import metrics as tobs
from repro_torch.serve import engine as P

NAME = "deepseek-v2-236b"
one_torch_thread = Z.one_torch_thread


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_the_reference(dtype):
    Z.check_forward(NAME, dtype)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_the_reference(dtype, per_row):
    Z.check_prefill_decode(NAME, dtype, per_row)


def test_per_rank_grads_match_jax_grad():
    Z.check_per_rank_grads(NAME)


def test_full_config_trees_match_the_reference_on_meta():
    Z.check_full_config(NAME)


def test_trees_cross_interop_both_ways():
    Z.check_interop(NAME)


def _no_q_lora():
    cfg = configs.get_smoke(NAME)
    return dataclasses.replace(cfg.mla, q_lora=0), cfg


def test_full_rank_queries_match_the_reference(rng):
    mla, cfg = _no_q_lora()
    jp = JMLA.init_mla(jax.random.key(3), cfg.d_model, cfg.n_heads, mla,
                       jnp.float32)
    assert "wq" in jp and "w_dq" not in jp
    p = interop.params_from_reference(jp)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    kw = dict(n_heads=cfg.n_heads, cfg=mla)
    want = jax.jit(functools.partial(JMLA.mla_attention, q_offset=3, **kw))(
        jp, jnp.asarray(x))
    got = TMLA.mla_attention(p, torch.from_numpy(x), q_offset=3, **kw)
    Z.close(got, want, 1e-5)
    cache_j = JMLA.init_mla_cache(2, 12, mla, jnp.float32)
    cache = TMLA.init_mla_cache(2, 12, mla, torch.float32)
    step = jax.jit(functools.partial(JMLA.mla_decode, **kw))
    for i, idx in enumerate(([4, 7], 8)):
        xt = x[:, i:i + 1]
        yj, cache_j = step(jp, jnp.asarray(xt), cache_j, jnp.asarray(idx))
        y, cache = TMLA.mla_decode(
            p, torch.from_numpy(xt), cache,
            torch.tensor(idx) if isinstance(idx, list) else idx, **kw)
        Z.close(y, yj, 1e-5)
        for k in ("c_kv", "k_rope"):
            Z.close(cache[k], cache_j[k], 1e-5, k)


@pytest.fixture(scope="module")
def smoke():
    yield from Z.chip_smoke_module()


def test_absorbed_attention_equals_materialized_keys_and_values(smoke, rng):
    cfg = configs.get_smoke(NAME)
    p = TMLA.init_mla(torch.Generator().manual_seed(0), cfg.d_model,
                      cfg.n_heads, cfg.mla, torch.float32)
    x = torch.from_numpy(rng.standard_normal((2, 11, cfg.d_model))
                         .astype(np.float32))
    got = TMLA.mla_attention(p, x, n_heads=cfg.n_heads, cfg=cfg.mla,
                             chunk=4)
    want = smoke.materialized_mla(p, x, cfg.mla, cfg.n_heads, 10000.0)
    Z.close(got, want, 1e-5)


def test_latent_cache_is_57x_smaller_than_per_head_kv():
    cfg = configs.get(NAME)
    cache = Model(cfg).init_cache(1, 1, device="meta")
    per_tok = sum(leaf.numel() * leaf.element_size()
                  for part in ("layers", "rem")
                  for c in cache[part].values() for leaf in c.values())
    assert per_tok == cfg.n_layers * (512 + 64) * 2
    gqa = cfg.n_layers * 2 * cfg.n_heads * 128 * 2
    assert round(gqa / per_tok) == 57


@pytest.fixture(scope="module")
def served():
    jm = JModel(jconfigs.get_smoke(NAME))
    jp = Z._cast(jax.jit(jm.init)(jax.random.key(0)), jnp.float32)
    return jm, jp, Model(configs.get_smoke(NAME)), \
        interop.params_from_reference(jp)


def test_engine_completions_equal_the_reference(served, rng):
    jm, jp, model, tp = served
    reqs = [(i, rng.integers(0, 512, n).astype(np.int32), g)
            for i, (n, g) in enumerate([(5, 4), (3, 6), (6, 3)])]
    outs = []
    for mod, m, p, rec in ((J, jm, jp, jobs.Recorder()),
                           (P, model, tp, tobs.Recorder())):
        eng = mod.ServeEngine(m, p, slots=2, max_seq=32, recorder=rec)
        for rid, prompt, n_new in reqs:
            eng.submit(mod.Request(rid=rid, prompt=prompt,
                                   max_new_tokens=n_new))
        done = eng.run_to_completion()
        outs.append(([c.tokens for c in done], eng.ticks,
                     rec.counter("serve.admitted")))
    assert outs[0] == outs[1]
    assert [len(t) for t in outs[1][0]] == [4, 6, 3]
