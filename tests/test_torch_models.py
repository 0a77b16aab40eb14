"""The port's ``Model`` (the ssm and hybrid serving paths) against the
reference's.

* At full rwkv6-1.6b width: ``Model.init(device="meta")`` leaves equal the
  reference's ``param_shapes()`` leaf by leaf (shape and dtype), and the
  cache tree equals the reference's ``init_cache`` (``jax.eval_shape``):
  no memory on either side.
* At ``SMOKE``, with the reference's seeded params carried over by
  ``interop``: ``prefill`` and two ``decode_step``s against the
  reference's (its prefill runs T decode steps under ``fori_loop``, the
  port's one ``rwkv6_prefill`` per layer).  f32-cast params and cache
  (as ``test_arch_smoke.py`` does, so the check is about semantics):
  logits within 1e-5 of their largest magnitude and 1e-5 relative (6.6e-7
  measured), the cache within 1e-5 of each leaf's largest magnitude.  bf16
  params: logits within 2^-5 of their largest magnitude (8.4e-3 measured;
  the port rounds each op to bf16 where XLA's fusions keep f32), every
  cache leaf within 2^-6 (9.3e-3 measured: the hidden stream's bf16 ulps
  carried into the shifts and the state), and the greedy tokens equal.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro_torch import configs, interop, tree
from repro_torch.models import Model
from repro_torch.models.config import ModelConfig

ARCH = "rwkv6-1.6b"


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


def test_full_config_param_shapes_match_the_reference():
    want = _leaves_by_path(JModel(jconfigs.get(ARCH)).param_shapes())
    got_tree = Model(configs.get(ARCH)).init(None, device="meta")
    got = _leaves_by_path(got_tree)
    assert list(got) == list(want)
    for k, leaf in got.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(want[k].shape), k
        assert _dt(leaf) == _dt(want[k]), k
    n = sum(leaf.numel() for leaf in tree.tree_leaves(got_tree))
    assert n == sum(int(np.prod(x.shape)) for x in want.values())
    assert n == 1_583_941_632


def test_full_config_cache_matches_the_reference():
    jm = JModel(jconfigs.get(ARCH))
    want = _leaves_by_path(jax.eval_shape(lambda: jm.init_cache(8, 64)))
    got = _leaves_by_path(Model(configs.get(ARCH)).init_cache(
        8, 64, device="meta"))
    assert list(got) == list(want)
    for k, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[k].shape), k
        assert _dt(leaf) == _dt(want[k]), k


def test_config_copy_matches_the_reference():
    for name in configs.names():
        for get in ("get", "get_smoke"):
            mine = getattr(configs, get)(name)
            ref = getattr(jconfigs, get)(name)
            assert isinstance(mine, ModelConfig)
            assert repr(mine).replace("repro_torch.", "repro.") == \
                repr(ref), name
            assert mine.param_count() == ref.param_count()


def test_unknown_names_raise_key_error():
    for name in ("no-such-model", "deepseek-v3", ""):
        with pytest.raises(KeyError, match="unknown model"):
            configs.get(name)
        with pytest.raises(KeyError, match="unknown model"):
            configs.get_smoke(name)


def test_every_reference_name_resolves():
    """All ten names of the reference's registry and ``acis-100m``, by
    their dashed ids and their module spellings, give the reference's
    config; ``names()`` is the reference's list in its order."""
    assert configs.names() == jconfigs.names()
    for name in jconfigs.names() + ["acis-100m"]:
        for spelling in (name, name.replace("-", "_").replace(".", "_")):
            assert configs.get(spelling) == configs.get(name)
            assert repr(configs.get(spelling)).replace(
                "repro_torch.", "repro.") == repr(jconfigs.get(name))


@pytest.fixture(scope="module")
def smoke():
    cfg_j = jconfigs.get_smoke(ARCH)
    jm = JModel(cfg_j)
    return jm, jm.init(jax.random.key(0)), Model(configs.get_smoke(ARCH))


def _run_reference(jm, jp, toks, nxt, cache):
    lg0, cache = jax.jit(jm.prefill)(jp, jnp.asarray(toks), cache)
    step = jax.jit(jm.decode_step)
    out = [np.asarray(lg0)]
    for i, tok in enumerate(nxt):
        lg, cache = step(jp, jnp.asarray(tok), cache, toks.shape[1] + i)
        out.append(np.asarray(lg))
    return out, jax.tree.map(np.asarray, cache)


def _run_port(model, tp, toks, nxt, cache):
    lg0, cache = model.prefill(tp, torch.from_numpy(toks), cache)
    out = [lg0.numpy()]
    for i, tok in enumerate(nxt):
        lg, cache = model.decode_step(tp, torch.from_numpy(tok), cache,
                                      toks.shape[1] + i)
        out.append(lg.numpy())
    return out, interop.params_to_reference(cache)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_prefill_and_decode_match_the_reference(smoke, rng, dtype):
    jm, jp, model = smoke
    cfg = model.cfg
    if dtype == "float32":
        jp = jax.tree.map(lambda p: p.astype(jnp.float32)
                          if p.dtype == jnp.bfloat16 else p, jp)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    b, t = 3, 11
    toks = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    nxt = [rng.integers(0, cfg.vocab, (b,)).astype(np.int32)
           for _ in range(2)]
    want, want_c = _run_reference(jm, jp, toks, nxt,
                                  jm.init_cache(b, 32, dtype=jdt))
    tp = interop.params_from_reference(jp)
    got, got_c = _run_port(model, tp, toks, nxt, model.init_cache(
        b, 32, dtype=getattr(torch, dtype), device="cpu"))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -5
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (b, cfg.vocab)
        np.testing.assert_allclose(g, w, rtol=1e-5 if dtype == "float32"
                                   else 0, atol=tol * np.abs(w).max())
        if dtype == "bfloat16":
            assert (g.argmax(-1) == w.argmax(-1)).all()
    stol = 1e-5 if dtype == "float32" else 2.0 ** -6
    for k, w in _leaves_by_path(want_c).items():
        g = _leaves_by_path(got_c)[k]
        assert g.dtype == w.dtype, k
        w32, g32 = w.astype(np.float32), g.astype(np.float32)
        np.testing.assert_allclose(g32, w32, rtol=0,
                                   atol=stol * np.abs(w32).max(), err_msg=k)


def test_cache_is_updated_in_place_and_clone_keeps_it(smoke, rng):
    jm, jp, model = smoke
    tp = interop.params_from_reference(jp)
    cache = model.init_cache(2, 32, device="cpu")
    keep = tree.tree_map(torch.clone, cache)
    ptrs = [x.data_ptr() for x in tree.tree_leaves(cache)]
    _, out = model.prefill(tp, torch.from_numpy(
        rng.integers(0, 512, (2, 5)).astype(np.int32)), cache)
    assert out is cache
    assert [x.data_ptr() for x in tree.tree_leaves(cache)] == ptrs
    assert all(not torch.equal(a, b) for a, b in zip(
        tree.tree_leaves(cache), tree.tree_leaves(keep)))
    assert all(not x.any() for x in tree.tree_leaves(keep))


def test_plain_and_kernel_switch_agree_on_the_cpu(smoke, rng):
    """On CPU tensors the kernel wrapper runs the plain version, so the
    two switches compute the same thing bit for bit and launch nothing."""
    from repro_torch.kernels import rwkv6_recurrence as RK
    jm, jp, model = smoke
    tp = interop.params_from_reference(jp)
    toks = torch.from_numpy(rng.integers(0, 512, (2, 6)).astype(np.int32))
    before = RK.launches
    outs = []
    for use in (True, False):
        m = Model(model.cfg, use_kernels=use)
        c = m.init_cache(2, 32, device="cpu")
        lg, c = m.prefill(tp, toks, c)
        lg2, c = m.decode_step(tp, toks[:, 0], c, 6)
        outs.append((lg, lg2, c["layers"]["pos0_rwkv"]["s"]))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert RK.launches == before


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    m = Model(configs.get_smoke(ARCH))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.init(torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.init_cache(1, 8)


def test_seeded_init_follows_the_reference_distributions():
    """Same leaves, dtypes and distributions as the reference's init (the
    draws differ: torch and JAX generators): constants equal, normals
    with the reference's scale."""
    cfg = configs.get_smoke(ARCH)
    p = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    jp = JModel(jconfigs.get_smoke(ARCH)).init(jax.random.key(0))
    got, want = _leaves_by_path(p), _leaves_by_path(jp)
    for k, w in want.items():
        g = got[k].float().numpy()
        w = np.asarray(w, np.float32)
        if np.all(w == w.flat[0]):                    # constants
            assert np.all(g == w), k
        else:
            assert abs(g.std() / w.std() - 1) < 0.15, k
            assert abs(g.mean()) < 0.2 * w.std(), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms_match_the_reference(rng, dtype, kind):
    """``apply_norm`` (f32 inside, the result in x's dtype) against the
    reference's on scaled, shifted rows: within one rounding of x's dtype
    (2^-8 relative for bf16, 1e-6 for f32)."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    jp = JL.init_norm(64, kind)
    jp = jax.tree.map(lambda a: a + jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)) * 0.1, jp)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(JL.apply_norm(jp, jx, eps=1e-6), np.float32)
    got = TL.apply_norm(interop.params_from_reference(jp),
                        interop._to_torch(np.asarray(jx)), eps=1e-6)
    assert got.dtype == getattr(torch, dtype)
    assert TL.init_norm(64, kind).keys() == jp.keys()
    tol = 2.0 ** -8 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# the hybrid family: recurrentgemma-9b
# ---------------------------------------------------------------------------
#
# Tolerances: f32-cast params, logits within 1e-5 of their largest
# magnitude and 1e-5 relative, each cache leaf within 1e-5 of its largest
# magnitude (f32 sums in other orders: flash attention over the prompt
# against the reference's softmax over the ring, the scan in time order
# against XLA's contracted a*h + b).  bf16 params: logits within 2^-5 of
# their largest magnitude, every cache leaf within 2^-6, ``pos`` equal (the
# port rounds each op to bf16 where XLA's fusions keep f32, as for
# rwkv6); greedy tokens are not compared in bf16, where a random-weight
# model's top-2 gaps are of the same size as those roundings.

HYB = "recurrentgemma-9b"


def test_hybrid_full_config_param_and_cache_shapes_match_the_reference():
    jm = JModel(jconfigs.get(HYB))
    want = _leaves_by_path(jm.param_shapes())
    got_tree = Model(configs.get(HYB)).init(None, device="meta")
    got = _leaves_by_path(got_tree)
    assert list(got) == list(want)
    for k, leaf in got.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(want[k].shape), k
        assert _dt(leaf) == _dt(want[k]), k
    n = sum(leaf.numel() for leaf in tree.tree_leaves(got_tree))
    assert n == 9_572_782_080
    assert sum(leaf.numel() * leaf.element_size()
               for leaf in tree.tree_leaves(got_tree)) == 19_147_259_904
    # 12 periods of (lru, lru, window) and an (lru, lru) remainder
    assert sorted(got_tree["layers"]) == ["pos0_lru", "pos1_lru",
                                          "pos2_window"]
    assert sorted(got_tree["rem"]) == ["rem0_lru", "rem1_lru"]
    for seq in (64, 4096):           # ring below and at the window
        want_c = _leaves_by_path(jax.eval_shape(
            lambda: jm.init_cache(8, seq)))
        got_c = _leaves_by_path(Model(configs.get(HYB)).init_cache(
            8, seq, device="meta"))
        assert list(got_c) == list(want_c)
        for k, leaf in got_c.items():
            assert tuple(leaf.shape) == tuple(want_c[k].shape), k
            assert _dt(leaf) == _dt(want_c[k]), k


@pytest.fixture(scope="module")
def hybrid():
    jm = JModel(jconfigs.get_smoke(HYB))
    return jm, jm.init(jax.random.key(0)), Model(configs.get_smoke(HYB))


def _hold_hybrid(got, want, got_c, want_c, dtype):
    f32 = dtype == "float32"
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5 if f32 else 0,
                                   atol=(1e-5 if f32 else 2.0 ** -5)
                                   * np.abs(w).max())
    stol = 1e-5 if f32 else 2.0 ** -6
    got_c = _leaves_by_path(got_c)
    for k, w in _leaves_by_path(want_c).items():
        g = got_c[k]
        assert g.dtype == w.dtype, k
        if k.endswith(".pos"):
            assert np.array_equal(g, w), k
            continue
        w32, g32 = w.astype(np.float32), g.astype(np.float32)
        np.testing.assert_allclose(g32, w32, rtol=0,
                                   atol=stol * np.abs(w32).max(), err_msg=k)


def _f32(jp):
    return jax.tree.map(lambda p: p.astype(jnp.float32)
                        if p.dtype == jnp.bfloat16 else p, jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [11, 21])
def test_hybrid_smoke_prefill_and_decode_match_the_reference(hybrid, rng,
                                                             dtype, t):
    """``prefill`` then three ``decode_step``s against the reference's
    (its prefill: T decode steps under ``fori_loop``); a 21-token prompt
    wraps the smoke config's 16-slot ring, and the decode steps after it
    write past the wrap."""
    jm, jp, model = hybrid
    if dtype == "float32":
        jp = _f32(jp)
    jdt = getattr(jnp, dtype)
    b = 3
    toks = rng.integers(0, 512, (b, t)).astype(np.int32)
    nxt = [rng.integers(0, 512, (b,)).astype(np.int32) for _ in range(3)]
    want, want_c = _run_reference(jm, jp, toks, nxt,
                                  jm.init_cache(b, 32, dtype=jdt))
    tp = interop.params_from_reference(jp)
    got, got_c = _run_port(model, tp, toks, nxt, model.init_cache(
        b, 32, dtype=getattr(torch, dtype), device="cpu"))
    _hold_hybrid(got, want, got_c, want_c, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_decode_with_per_row_index_matches_the_reference(hybrid, rng,
                                                                dtype):
    """``decode_step`` with one position per row (the engine's call): rows
    started at different offsets, one of them past the window."""
    jm, jp, model = hybrid
    if dtype == "float32":
        jp = _f32(jp)
    jdt = getattr(jnp, dtype)
    b, steps = 3, 6
    start = np.array([0, 4, 13], np.int32)
    jc = jm.init_cache(b, 40, dtype=jdt)
    tp = interop.params_from_reference(jp)
    tc = model.init_cache(b, 40, dtype=getattr(torch, dtype), device="cpu")
    step = jax.jit(jm.decode_step)
    # walk each row to its start position first (token 1 in lockstep rows
    # that have not started: they are overwritten by the per-row steps)
    for i in range(int(start.max())):
        tok = rng.integers(0, 512, (b,)).astype(np.int32)
        idx = np.minimum(i, start)
        _, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(idx))
        _, tc = model.decode_step(tp, torch.from_numpy(tok), tc,
                                  torch.from_numpy(idx))
    want, got = [], []
    for i in range(steps):
        tok = rng.integers(0, 512, (b,)).astype(np.int32)
        idx = start + i
        lg, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(idx))
        want.append(np.asarray(lg))
        lg, tc = model.decode_step(tp, torch.from_numpy(tok), tc,
                                   torch.from_numpy(idx))
        got.append(lg.numpy())
    _hold_hybrid(got, want, interop.params_to_reference(tc),
                 jax.tree.map(np.asarray, jc), dtype)


def test_hybrid_trees_cross_interop_both_ways(hybrid, rng):
    """Params and a used cache (bf16 rings, f32 states, int32 ``pos``)
    carried to the port and back: same tree, dtypes and values."""
    jm, jp, model = hybrid
    jc = jm.init_cache(2, 20)
    _, jc = jax.jit(jm.prefill)(jp, jnp.asarray(
        rng.integers(0, 512, (2, 18)).astype(np.int32)), jc)
    for ref_tree in (jp, jc):
        port = interop.params_from_reference(ref_tree)
        back = interop.params_to_reference(port)
        want, got = _leaves_by_path(ref_tree), _leaves_by_path(back)
        assert list(got) == list(want)
        for k, w in want.items():
            assert _dt(got[k]) == _dt(w), k
            assert np.array_equal(np.asarray(got[k], np.float32),
                                  np.asarray(w, np.float32)), k
    pos = interop.cache_from_reference(jc)["layers"]["pos2_window"]["pos"]
    assert pos.dtype == torch.int32 and int(pos.max()) == 17


def test_hybrid_plain_and_kernel_switch_agree_on_the_cpu(hybrid, rng):
    """On CPU tensors ``rglru_scan`` runs its plain version: both switches
    compute the same thing bit for bit and launch nothing."""
    from repro_torch.kernels import chunk_scan as CS
    jm, jp, model = hybrid
    tp = interop.params_from_reference(jp)
    toks = torch.from_numpy(rng.integers(0, 512, (2, 6)).astype(np.int32))
    before = CS.rglru_launches
    outs = []
    for use in (True, False):
        m = Model(model.cfg, use_kernels=use)
        c = m.init_cache(2, 32, device="cpu")
        lg, c = m.prefill(tp, toks, c)
        lg2, c = m.decode_step(tp, toks[:, 0], c, 6)
        outs.append((lg, lg2, c["rem"]["rem1_lru"]["h"],
                     c["layers"]["pos2_window"]["k"]))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert CS.rglru_launches == before


def test_hybrid_seeded_init_follows_the_reference_distributions():
    """Same leaves, dtypes and distributions as the reference's init (the
    draws differ: torch and JAX generators): constants equal, normals with
    the reference's scale, and Λ drawn so
    that the decay at r = 1/2 lies in the reference's (0.9, 0.999)."""
    cfg = configs.get_smoke(HYB)
    p = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    jp = JModel(jconfigs.get_smoke(HYB)).init(jax.random.key(0))
    got, want = _leaves_by_path(p), _leaves_by_path(jp)
    assert list(got) == list(want)
    for k, w in want.items():
        assert _dt(got[k]) == _dt(w), k
        g = got[k].float().numpy()
        w = np.asarray(w, np.float32)
        if k.endswith(".lam"):
            for lam in (g, w):
                a = np.exp(-8 * np.logaddexp(lam, 0) * 0.5)
                assert a.min() > 0.9 - 1e-6 and a.max() < 0.999 + 1e-6, k
        elif np.all(w == w.flat[0]):                  # constants
            assert np.all(g == w), k
        else:
            # two sample stds of n draws: their ratio's spread is about
            # 1/sqrt(n), so allow 5 of it (the conv kernels hold 256)
            tol = max(0.15, 5 / np.sqrt(w.size))
            assert abs(g.std() / w.std() - 1) < tol, k
            assert abs(g.mean()) < 0.2 * w.std(), k
