"""The port's dense family (GQA attention with a full KV cache) against the
reference's.

Every test carries the reference's seeded params (``jax.random.key(0)``)
to the port through ``interop.params_from_reference`` and feeds both the
same seeded numpy tokens.

* ``gqa_decode`` alone, with a scalar index (lockstep) and a per-row
  index vector (continuous batching), on f32 params: output and cache
  within 1e-5 of their largest magnitude.
* ``prefill`` (the batched ``_prefill_gqa_fast``) and two
  ``decode_step``s on the ``SMOKE`` configs of acis-100m, qwen3-8b
  (qk-norm), granite-8b and nemotron-4-15b (relu2).  f32-cast params:
  logits within 1e-5 of their largest magnitude and 1e-5 relative (up to
  6e-7 measured), each cache leaf within 1e-5 of its largest magnitude.
  bf16 params: logits within 2^-5 of their largest magnitude (1.1e-2
  measured: the port rounds each op to bf16 where XLA's fusions keep
  f32), each cache leaf within 2^-6; greedy tokens compared only where
  the reference's top-2 gap exceeds twice that bound.
* the inference ``forward`` (hidden states after the final norm) on f32
  params within 1e-5 of the largest magnitude.
* full-width param and cache trees (shapes and dtypes on ``meta``) and
  the interop round trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.models import attention as JA
from repro_torch import configs, interop, tree
from repro_torch.models import Model
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT

DENSE = ["acis-100m", "qwen3-8b", "granite-8b", "nemotron-4-15b"]


def _leaves_by_path(t, prefix=""):
    if isinstance(t, dict):
        out = {}
        for k in sorted(t):
            out.update(_leaves_by_path(t[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: t}


def _dt(x) -> str:
    return str(np.dtype(x.dtype)) if not isinstance(x, torch.Tensor) \
        else str(x.dtype).replace("torch.", "")


def _f32(jp):
    return jax.tree.map(lambda p: p.astype(jnp.float32)
                        if p.dtype == jnp.bfloat16 else p, jp)


@pytest.fixture(scope="module")
def smokes():
    out = {}
    for arch in DENSE:
        jm = JModel(jconfigs.get_smoke(arch))
        out[arch] = (jm, jm.init(jax.random.key(0)),
                     Model(configs.get_smoke(arch)))
    return out


def _run_reference(jm, jp, toks, nxt, cache, index):
    lg0, cache = jax.jit(jm.prefill)(jp, jnp.asarray(toks), cache)
    step = jax.jit(jm.decode_step)
    out = [np.asarray(lg0)]
    for i, tok in enumerate(nxt):
        lg, cache = step(jp, jnp.asarray(tok), cache, index(i))
        out.append(np.asarray(lg))
    return out, jax.tree.map(np.asarray, cache)


def _run_port(model, tp, toks, nxt, cache, index):
    lg0, cache = model.prefill(tp, torch.from_numpy(toks), cache)
    out = [lg0.numpy()]
    for i, tok in enumerate(nxt):
        idx = index(i)
        idx = torch.from_numpy(idx) if isinstance(idx, np.ndarray) else idx
        lg, cache = model.decode_step(tp, torch.from_numpy(tok), cache, idx)
        out.append(lg.numpy())
    return out, interop.params_to_reference(cache)


def hold(got, want, got_c, want_c, dtype):
    """The module docstring's tolerances."""
    f32 = dtype == "float32"
    tol = 1e-5 if f32 else 2.0 ** -5
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5 if f32 else 0,
                                   atol=tol * np.abs(w).max())
        top = np.sort(w, -1)
        clear = top[:, -1] - top[:, -2] > 2 * tol * np.abs(w).max()
        assert (g.argmax(-1) == w.argmax(-1))[clear].all()
    stol = 1e-5 if f32 else 2.0 ** -6
    want_l, got_l = _leaves_by_path(want_c), _leaves_by_path(got_c)
    assert list(got_l) == list(want_l)
    for k, w in want_l.items():
        assert _dt(got_l[k]) == _dt(w), k
        w32, g32 = w.astype(np.float32), got_l[k].astype(np.float32)
        np.testing.assert_allclose(g32, w32, rtol=0,
                                   atol=stol * np.abs(w32).max(), err_msg=k)


# ---------------------------------------------------------------------------
# the attention layer alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["scalar", "vector"])
def test_gqa_decode_matches_the_reference(rng, form):
    """One decode step against a cache holding 5 earlier positions (per
    row 3..6 with a vector index): output and cache within 1e-5."""
    b, s, d, hq, hkv, dh = 3, 12, 32, 4, 2, 8
    kw = dict(n_heads=hq, n_kv=hkv, d_head=dh, qk_norm=True,
              rope_theta=10000.0)
    jp = JA.init_gqa(jax.random.key(3), d, hq, hkv, dh, True, jnp.float32)
    x = rng.standard_normal((b, 1, d)).astype(np.float32)
    cache = {n: rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
             for n in ("k", "v")}
    index = np.int32(5) if form == "scalar" \
        else np.array([3, 6, 4], np.int32)
    want, want_c = jax.jit(lambda p, x, c, i: JA.gqa_decode(
        p, x, c, i, **kw))(jp, x, cache, index)
    tc = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    t_index = 5 if form == "scalar" else torch.from_numpy(index)
    got, got_c = TA.gqa_decode(interop.params_from_reference(jp),
                               torch.from_numpy(x), tc, t_index, **kw)
    assert got_c is tc                          # written in place
    w = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), w, rtol=0,
                               atol=1e-5 * np.abs(w).max())
    for n in ("k", "v"):
        wc = np.asarray(want_c[n])
        np.testing.assert_allclose(tc[n].numpy(), wc, rtol=0,
                                   atol=1e-5 * np.abs(wc).max())


def test_gqa_decode_takes_a_zero_dim_index_tensor(rng):
    """A 0-dim index tensor writes and masks as the int does."""
    b, s, d, h, dh = 2, 6, 16, 2, 8
    p = interop.params_from_reference(
        JA.init_gqa(jax.random.key(1), d, h, h, dh, False, jnp.float32))
    x = torch.from_numpy(rng.standard_normal((b, 1, d)).astype(np.float32))
    outs = []
    for idx in (3, torch.tensor(3)):
        c = TA.init_gqa_cache(b, s, h, dh, torch.float32)
        y, c = TA.gqa_decode(p, x, c, idx, n_heads=h, n_kv=h, d_head=dh)
        outs.append((y, c["k"]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert outs[0][1][:, 3].abs().sum() > 0 and \
        outs[0][1][:, :3].abs().sum() == 0


# ---------------------------------------------------------------------------
# the whole stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_smoke_prefill_and_decode_match_the_reference(smokes, rng, arch,
                                                      dtype):
    jm, jp, model = smokes[arch]
    cfg = model.cfg
    jp = _f32(jp) if dtype == "float32" else jp
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    b, t = 3, 11
    toks = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    nxt = [rng.integers(0, cfg.vocab, (b,)).astype(np.int32)
           for _ in range(2)]
    want, want_c = _run_reference(jm, jp, toks, nxt,
                                  jm.init_cache(b, 32, dtype=jdt),
                                  lambda i: t + i)
    got, got_c = _run_port(model, interop.params_from_reference(jp), toks,
                           nxt, model.init_cache(b, 32,
                                                 dtype=getattr(torch, dtype),
                                                 device="cpu"),
                           lambda i: t + i)
    hold(got, want, got_c, want_c, dtype)


def test_decode_with_per_row_index_matches_the_reference(smokes, rng):
    """Continuous batching: rows at their own positions (qwen3-8b, f32)."""
    jm, jp, model = smokes["qwen3-8b"]
    jp = _f32(jp)
    b, t = 3, 7
    toks = rng.integers(0, 512, (b, t)).astype(np.int32)
    nxt = [rng.integers(0, 512, (b,)).astype(np.int32) for _ in range(3)]
    rows = np.array([7, 9, 8], np.int32)
    idx = (lambda i: rows + i)
    want, want_c = _run_reference(jm, jp, toks, nxt,
                                  jm.init_cache(b, 24, dtype=jnp.float32),
                                  idx)
    got, got_c = _run_port(model, interop.params_from_reference(jp), toks,
                           nxt, model.init_cache(b, 24, torch.float32,
                                                 device="cpu"), idx)
    hold(got, want, got_c, want_c, "float32")


@pytest.mark.parametrize("arch", ["acis-100m", "qwen3-8b"])
def test_inference_forward_matches_the_reference(smokes, rng, arch):
    jm, jp, model = smokes[arch]
    jp = _f32(jp)
    toks = rng.integers(0, model.cfg.vocab, (2, 9)).astype(np.int32)
    want, _ = jax.jit(jm.forward)(jp, jnp.asarray(toks))
    got, aux = TT.forward(interop.params_from_reference(jp), model.cfg,
                          torch.from_numpy(toks))
    w = np.asarray(want)
    assert got.shape == w.shape and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), w, rtol=0,
                               atol=1e-5 * np.abs(w).max())


def test_prefill_writes_the_prompt_and_leaves_the_rest(smokes, rng):
    """``_prefill_gqa_fast`` fills positions [0, T) of every layer's
    cache in place and leaves the rest zero."""
    jm, jp, model = smokes["granite-8b"]
    tp = interop.params_from_reference(jp)
    cache = model.init_cache(2, 16, device="cpu")
    toks = torch.from_numpy(rng.integers(0, 512, (2, 5)).astype(np.int32))
    _, out = model.prefill(tp, toks, cache)
    assert out is cache
    k = cache["layers"]["pos0_self"]["k"]
    assert k[:, :, :5].abs().amin(-1).amin(-1).gt(0).all()
    assert k[:, :, 5:].abs().sum() == 0


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_full_config_param_and_cache_trees_match_the_reference(arch):
    jm = JModel(jconfigs.get(arch))
    model = Model(configs.get(arch))
    for want_t, got_t in (
            (jm.param_shapes(), model.param_shapes()),
            (jax.eval_shape(lambda: jm.init_cache(8, 64)),
             model.init_cache(8, 64, device="meta"))):
        want, got = _leaves_by_path(want_t), _leaves_by_path(got_t)
        assert list(got) == list(want)
        for k, leaf in got.items():
            assert tuple(leaf.shape) == tuple(want[k].shape), k
            assert _dt(leaf) == _dt(want[k]), k
    n = sum(x.numel() for x in tree.tree_leaves(model.param_shapes()))
    assert n == sum(int(np.prod(x.shape))
                    for x in jax.tree.leaves(jm.param_shapes()))


def test_dense_trees_cross_interop_both_ways(smokes, rng):
    """Params and a used cache carried to the port and back: same tree,
    dtypes and values."""
    jm, jp, _ = smokes["qwen3-8b"]
    jc = jm.init_cache(2, 12)
    _, jc = jax.jit(jm.prefill)(jp, jnp.asarray(
        rng.integers(0, 512, (2, 6)).astype(np.int32)), jc)
    for ref_tree in (jp, jc):
        port = interop.params_from_reference(ref_tree)
        back = interop.params_to_reference(port)
        want, got = _leaves_by_path(ref_tree), _leaves_by_path(back)
        assert list(got) == list(want)
        for k, w in want.items():
            assert _dt(got[k]) == _dt(w), k
            assert np.array_equal(np.asarray(got[k], np.float32),
                                  np.asarray(w, np.float32)), k
