"""The encdec family (whisper-small) against the reference.

* The smoke model (2 encoder + 2 decoder layers, LayerNorm, GELU) through
  the shared checks of ``tests/zoo_parity.py``, its context from
  ``synthetic_context``: forward, prefill and decode with a scalar and a
  per-row index (logits and every cache leaf), the train step's per-rank
  gradients with the context split over the ranks, the full config's
  trees on the meta device (``enc``, ``dec_pos [32768, 768]``).
* ``encode`` against the reference's (f32 within 1e-5 of the largest
  magnitude); the encoder is live: two contexts give logits apart by
  more than 2^-4 of their largest magnitude.
* A decode step without a context (what the reference's ``ServeEngine``
  runs, ROADMAP.md R6: the cross attention reads the decoded token
  itself) against the reference's, f32 within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoo_parity as Z
from repro.models import transformer as JT
from repro_torch.data.pipeline import synthetic_context
from repro_torch.models import transformer as TT

NAME = "whisper-small"
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


def test_encoder_matches_the_reference_and_is_live():
    jm, jp, model, tp, ctx = Z._setup(NAME, "float32")
    want = jax.jit(lambda p, c: JT.encode(p, jm.cfg, c))(jp, jnp.asarray(ctx))
    got = TT.encode(tp, model.cfg, Z._tctx(ctx))
    Z.close(got, want, 1e-5)
    toks, _ = Z._tokens(model.cfg)
    other = torch.from_numpy(synthetic_context(9, *ctx.shape))
    lg = [model.logits(tp, model.forward(tp, torch.from_numpy(toks),
                                         context=c)[0])
          for c in (Z._tctx(ctx), other)]
    assert (lg[0] - lg[1]).abs().max() > 2.0 ** -4 * lg[0].abs().max()


def test_decode_without_context_attends_to_the_token_like_the_reference():
    jm, jp, model, tp, _ = Z._setup(NAME, "float32")
    toks, nxt = Z._tokens(model.cfg)
    cache_j = jm.init_cache(Z.B, Z.SEQ, dtype=jnp.float32)
    cache = model.init_cache(Z.B, Z.SEQ, dtype=torch.float32, device="cpu")
    step = jax.jit(jm.decode_step)
    for i in range(3):
        idx = np.array([i, 2 * i], np.int32)
        want, cache_j = step(jp, jnp.asarray(toks[:, i]), cache_j,
                             jnp.asarray(idx))
        got, cache = model.decode_step(tp, torch.from_numpy(toks[:, i]),
                                       cache, torch.from_numpy(idx))
        Z.close(got, want, 1e-5)
