"""Shared checks of the MLA (deepseek-v2), encdec (whisper) and vlm
(llama vision) families against the reference, on the smoke configs
(``tests/test_torch_{mla,encdec,vlm}.py`` run them, one family a file).

The reference's seeded params are carried over by ``interop`` (with the
vlm cross gates drawn non-zero from the seed: at their initial 0 a wrong
cross attention would pass), and whisper and vlm read a context from
``synthetic_context`` in the params' dtype.

* :func:`check_forward`, ``Model.forward``: hidden states and aux loss.
  f32: within 1e-5 relative and 1e-5 of the largest magnitude; bf16:
  within 2^-5 of the largest |hidden| (the port rounds each op to bf16
  where XLA's fusions keep f32).
* :func:`check_prefill_decode`, ``prefill`` (T decode steps in both
  packages) then two ``decode_step``s, with a scalar index or a per-row
  index (rows at positions T and T - 3: the per-row cache writes and
  masks): the logits and every cache leaf.  f32: logits within 1e-5
  relative and of their largest magnitude, cache leaves within 1e-5 of
  theirs; bf16: logits within 2^-5 of their largest magnitude with the
  greedy tokens equal up to near-ties (:func:`assert_greedy`), cache
  leaves within 2^-6.
* :func:`check_per_rank_grads`, the train step's per-rank gradients with
  context on ``LocalMesh({"data": 2})`` (f32) against ``jax.grad`` of
  each rank's shard: each leaf within 1e-5 of its largest magnitude.
* :func:`check_full_config`, the full config's param and cache trees on
  the meta device against ``jax.eval_shape`` (shapes, dtypes, counts),
  the stub context's shape and dtype, and the analytic param count
  against the actual one within the reference's 35%
  (``test_param_count_analytic_vs_actual``), at full and smoke size.
* :func:`chip_smoke_module`, ``chip_smoke.py`` loaded as a module, for
  its phases' rehearsals and its oracles (``materialized_mla``).
"""

import dataclasses
import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.train import step as jstep
from repro_torch import configs, interop, tree
from repro_torch.data.pipeline import synthetic_context
from repro_torch.mesh import LocalMesh
from repro_torch.models import Model
from repro_torch.train import step as S

B, T, SEQ = 2, 7, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: many small ops, which several threads a
    worker slow down when the suite's workers share the cores (a test
    module imports it to use it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def with_gates(jp, seed: int = 0):
    """The reference's params with every cross gate drawn from ``seed``
    (uniform in ±[0.3, 1.2], so tanh is well away from 0)."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        if jax.tree_util.keystr(path).split("'")[-2] in ("gate_attn",
                                                         "gate_ffn"):
            g = rng.uniform(0.3, 1.2, x.shape) * rng.choice([-1, 1], x.shape)
            return jnp.asarray(g, jnp.float32)
        return x

    return jax.tree_util.tree_map_with_path(draw, jp)


def close(got, want, rel, what=""):
    """Every element within ``rel`` of ``want``'s largest magnitude."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _cast(tree_, dtype):
    return jax.tree.map(lambda p: p.astype(dtype)
                        if p.dtype == jnp.bfloat16 else p, tree_)


def assert_greedy(got, want, tol):
    """The greedy tokens equal, but where the reference's top two logits
    lie within ``2 · tol`` of each other: logits that each move by up to
    ``tol`` may swap there, so the port's pick must then be one of the
    reference's within ``2 · tol`` of its max (random bf16 weights have
    such near-ties: a vlm row's top-2 gap is 0.0033 of its max |logit|,
    the logits' difference 0.013)."""
    pick = got.argmax(-1)
    same = pick == want.argmax(-1)
    near = np.take_along_axis(want, pick[:, None], -1)[:, 0] \
        >= want.max(-1) - 2 * tol
    assert (same | near).all(), (pick, want.argmax(-1))
    assert same.any()


@functools.lru_cache(maxsize=None)
def _setup(name: str, dtype: str):
    """(reference model, its params, the port's model, params, the
    context as numpy in ``dtype`` or None)."""
    jm = JModel(jconfigs.get_smoke(name))
    jp = with_gates(jax.jit(jm.init)(jax.random.key(0)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = _cast(jp, jdt)
    spec = jm.context_inputs(B)
    ctx = None if spec is None else np.asarray(
        jnp.asarray(synthetic_context(0, B, spec.shape[1], spec.shape[2]),
                    jdt))
    return jm, jp, Model(configs.get_smoke(name)), \
        interop.params_from_reference(jp), ctx


def _tctx(ctx):
    return None if ctx is None else interop.params_from_reference(ctx)


def _jctx(ctx):
    return None if ctx is None else jnp.asarray(ctx)


def _tokens(cfg):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    nxt = [rng.integers(0, cfg.vocab, (B,)).astype(np.int32)
           for _ in range(2)]
    return toks, nxt


def _indices(per_row: bool):
    if per_row:
        return [np.array([T + i, T - 3 + i], np.int32) for i in range(2)]
    return [T, T + 1]


@functools.lru_cache(maxsize=None)
def _reference_run(name: str, dtype: str, per_row: bool):
    jm, jp, _, _, ctx = _setup(name, dtype)
    toks, nxt = _tokens(jm.cfg)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    cache = jm.init_cache(B, SEQ, dtype=jdt)
    lg, cache = jax.jit(jm.prefill)(jp, jnp.asarray(toks), cache,
                                    context=_jctx(ctx))
    out = [np.asarray(lg)]
    step = jax.jit(jm.decode_step)
    for tok, idx in zip(nxt, _indices(per_row)):
        lg, cache = step(jp, jnp.asarray(tok), cache, jnp.asarray(idx),
                         context=_jctx(ctx))
        out.append(np.asarray(lg))
    return out, _leaves_by_path(jax.tree.map(np.asarray, cache))


def _port_run(name: str, dtype: str, per_row: bool):
    _, _, model, tp, ctx = _setup(name, dtype)
    toks, nxt = _tokens(model.cfg)
    cache = model.init_cache(B, SEQ, dtype=getattr(torch, dtype),
                             device="cpu")
    lg, cache = model.prefill(tp, torch.from_numpy(toks), cache,
                              context=_tctx(ctx))
    out = [lg.numpy()]
    for tok, idx in zip(nxt, _indices(per_row)):
        idx = torch.from_numpy(idx) if per_row else idx
        lg, cache = model.decode_step(tp, torch.from_numpy(tok), cache, idx,
                                      context=_tctx(ctx))
        out.append(lg.numpy())
    return out, _leaves_by_path(interop.params_to_reference(cache))


def check_forward(name: str, dtype: str) -> None:
    jm, jp, model, tp, ctx = _setup(name, dtype)
    toks, _ = _tokens(jm.cfg)
    h_j, aux_j = jax.jit(lambda p, t, c: jm.forward(p, t, context=c))(
        jp, jnp.asarray(toks), _jctx(ctx))
    h, aux = model.forward(tp, torch.from_numpy(toks), context=_tctx(ctx))
    assert h.dtype == getattr(torch, dtype) and h.shape == h_j.shape
    h_j = np.asarray(h_j, np.float32)
    g = h.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(g, h_j, rtol=1e-5,
                                   atol=1e-5 * np.abs(h_j).max())
    else:
        np.testing.assert_allclose(g, h_j, rtol=0,
                                   atol=2.0 ** -5 * np.abs(h_j).max())
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-5,
                               atol=1e-7)
    if name != "deepseek-v2-236b":
        assert float(aux) == 0.0


def check_prefill_decode(name: str, dtype: str, per_row: bool) -> None:
    want, want_c = _reference_run(name, dtype, per_row)
    got, got_c = _port_run(name, dtype, per_row)
    vocab = configs.get_smoke(name).vocab
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (B, vocab)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())
        else:
            tol = 2.0 ** -5 * np.abs(w).max()
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)
            assert_greedy(g, w, tol)
    assert list(got_c) == list(want_c)
    stol = 1e-5 if dtype == "float32" else 2.0 ** -6
    for k, w in want_c.items():
        g = got_c[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        w32, g32 = w.astype(np.float32), g.astype(np.float32)
        np.testing.assert_allclose(g32, w32, rtol=0,
                                   atol=stol * np.abs(w32).max(), err_msg=k)


def check_per_rank_grads(name: str) -> None:
    cfg_j = dataclasses.replace(jconfigs.get_smoke(name),
                                param_dtype="float32", dtype="float32")
    cfg_t = dataclasses.replace(configs.get_smoke(name),
                                param_dtype="float32", dtype="float32")
    jm = JModel(cfg_j)
    jp = jax.jit(jm.init)(jax.random.key(0))
    n, b, t = 2, 2, 12
    toks = np.random.default_rng(0).integers(
        0, cfg_j.vocab, (n * b, t + 1)).astype(np.int32)
    batch = {"tokens": toks}
    spec = jm.context_inputs(n * b)
    if spec is not None:
        batch["context"] = synthetic_context(3, n * b, spec.shape[1],
                                             spec.shape[2])
    state = S.TrainState(interop.params_from_reference(jp), None,
                         torch.zeros((), dtype=torch.int32))
    grads, metrics = S.local_grads(Model(cfg_t), state, batch,
                                   LocalMesh({"data": n}, device="cpu"))
    grad = jax.jit(jax.grad(lambda p, x, c: jstep._loss_fn(jm, p, x, c,
                                                           None),
                            has_aux=True))
    for r in range(n):
        rows = slice(r * b, (r + 1) * b)
        c = None if spec is None else jnp.asarray(batch["context"][rows])
        gj, mj = grad(jp, jnp.asarray(toks[rows]), c)
        got = _leaves_by_path(grads)
        for k, a in _leaves_by_path(gj).items():
            close(got[k][r], a, 1e-5, f"{name} rank {r} {k}")
        for k in ("nll", "aux"):
            np.testing.assert_allclose(float(metrics[k][r]), float(mj[k]),
                                       rtol=1e-5, atol=1e-7)


def check_full_config(name: str) -> None:
    jm = JModel(jconfigs.get(name))
    model = Model(configs.get(name))
    want = _leaves_by_path(jm.param_shapes())
    got_tree = model.param_shapes()
    got = _leaves_by_path(got_tree)
    assert list(got) == list(want)
    for k, leaf in got.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(want[k].shape), k
        assert _dt(leaf) == _dt(want[k]), k
    n = sum(leaf.numel() for leaf in tree.tree_leaves(got_tree))
    assert n == sum(int(np.prod(x.shape)) for x in want.values())
    assert abs(model.cfg.param_count() - n) / n < 0.35
    want_c = _leaves_by_path(jax.eval_shape(lambda: jm.init_cache(2, 64)))
    got_c = _leaves_by_path(model.init_cache(2, 64, device="meta"))
    assert list(got_c) == list(want_c)
    for k, leaf in got_c.items():
        assert tuple(leaf.shape) == tuple(want_c[k].shape), k
        assert _dt(leaf) == _dt(want_c[k]), k
    spec = jm.context_inputs(3)
    mine = model.context_inputs(3)
    assert (mine is None) == (spec is None)
    if spec is not None:
        assert mine[0] == spec.shape and _dt(torch.empty(0, dtype=mine[1])) \
            == _dt(spec)
    smoke = Model(configs.get_smoke(name))
    n = sum(x.numel() for x in tree.tree_leaves(smoke.param_shapes()))
    assert abs(smoke.cfg.param_count() - n) / n < 0.35


def check_interop(name: str) -> None:
    """The reference's params (bf16, the drawn gates, ``enc``, ``dec_pos``,
    the MLA leaves) through ``params_from_reference`` and back, bit for
    bit with their dtypes and 0-dim shapes; and its AdamW train state
    through ``train_state_from_reference``."""
    from repro.train import optimizer as jopt

    jm, jp, _, tp, _ = _setup(name, "bfloat16")
    back = interop.params_to_reference(tp)
    want = _leaves_by_path(jax.tree.map(np.asarray, jp))
    got = _leaves_by_path(back)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(got[k].astype(np.float32),
                              w.astype(np.float32)), k
    st = jstep.TrainState(jp, jopt.adamw(1e-3).init(jp),
                          jnp.asarray(3, jnp.int32))
    mine = interop.train_state_from_reference(
        st, LocalMesh({"data": 2}, device="cpu"))
    assert int(mine.step) == 3
    for a, b in zip(jax.tree.leaves((st.params, st.opt)),
                    tree.tree_leaves((mine.params, mine.opt))):
        assert tuple(b.shape) == a.shape and _dt(b) == _dt(a)
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())


def chip_smoke_module():
    """Yield ``chip_smoke.py`` (a script at the repo's root) loaded as the
    module ``chip_smoke``, and unregister it afterwards: the body of a
    module-scoped fixture."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod         # dataclasses look it up
    try:
        spec.loader.exec_module(mod)
        yield mod
    finally:
        del sys.modules["chip_smoke"]
