"""The vlm family (llama-3.2-vision-11b) against the reference.

* The smoke model (4 layers: 2 periods of a gated cross-attention layer
  and a self-attention layer) with its cross gates drawn non-zero from
  the seed, through the shared checks of ``tests/zoo_parity.py``, the
  image embeddings from ``synthetic_context``: forward, prefill and
  decode with a scalar and a per-row index (logits and every cache
  leaf; ``cross`` layers cache nothing), the train step's per-rank
  gradients (the gates rank-stacked ``[data]``), the full config's trees
  on the meta device (the gates 0-dim f32, stacked ``[8]``).
* The gates: at their initial 0 the image embeddings change nothing; at
  the drawn values two contexts give logits apart by more than 2^-4 of
  their largest magnitude.
* A decode step without a context (the reference's ``ServeEngine``,
  ROADMAP.md R6) against the reference's, f32 within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoo_parity as Z
from repro_torch import tree
from repro_torch.data.pipeline import synthetic_context

NAME = "llama-3.2-vision-11b"
one_torch_thread = Z.one_torch_thread


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_the_reference(dtype):
    Z.check_forward(NAME, dtype)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_the_reference(dtype, per_row):
    Z.check_prefill_decode(NAME, dtype, per_row)


def test_per_rank_grads_with_context_match_jax_grad():
    Z.check_per_rank_grads(NAME)


def test_full_config_trees_match_the_reference_on_meta():
    Z.check_full_config(NAME)


def test_trees_cross_interop_both_ways():
    Z.check_interop(NAME)


def _logits(model, params, toks, ctx):
    return model.logits(params, model.forward(params, toks, context=ctx)[0])


def test_context_is_read_only_through_the_gates():
    _, _, model, tp, ctx = Z._setup(NAME, "float32")
    cross = tp["layers"]["pos0_cross"]
    assert cross["gate_attn"].shape == (2,) and cross["gate_attn"].all()
    toks = torch.from_numpy(Z._tokens(model.cfg)[0])
    a = Z._tctx(ctx)
    b = torch.from_numpy(synthetic_context(9, *ctx.shape))
    live = [_logits(model, tp, toks, c) for c in (a, b)]
    assert (live[0] - live[1]).abs().max() > 2.0 ** -4 * live[0].abs().max()
    shut = tree.tree_map(lambda x: x, tp)
    shut["layers"]["pos0_cross"] = dict(cross, gate_attn=torch.zeros(2),
                                        gate_ffn=torch.zeros(2))
    dead = [_logits(model, shut, toks, c) for c in (a, b)]
    assert torch.equal(dead[0], dead[1])


def test_decode_without_context_attends_to_the_token_like_the_reference():
    jm, jp, model, tp, _ = Z._setup(NAME, "float32")
    toks, _ = Z._tokens(model.cfg)
    cache_j = jm.init_cache(Z.B, Z.SEQ, dtype=jnp.float32)
    cache = model.init_cache(Z.B, Z.SEQ, dtype=torch.float32, device="cpu")
    step = jax.jit(jm.decode_step)
    for i in range(3):
        want, cache_j = step(jp, jnp.asarray(toks[:, i]), cache_j, i)
        got, cache = model.decode_step(tp, torch.from_numpy(toks[:, i]),
                                       cache, i)
        Z.close(got, want, 1e-5)
