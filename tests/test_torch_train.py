"""The port's training path (``repro_torch.train``) against the reference's.

The same seeded numpy input goes to the reference (JAX on the CPU) and to
the port (``device="cpu"``).  Tolerances, each with its reason:

* ``cross_entropy`` and its metrics, f32: within 1e-6 relative (one
  logsumexp in each package, summed in its own order); argmax ties take
  the first index in both.
* ``adamw``, ``adafactor`` and ``warmup_cosine`` on identical params and
  gradients: within 1e-6 relative of each leaf's largest magnitude (f32
  elementwise, the same order of operations; ``pow``/``cos``/``rsqrt``
  may differ by an ulp between XLA and torch).
* per-rank gradients of the port's step against ``jax.grad`` of each
  rank's shard (f32 configs): each leaf within 1e-5 of its largest
  magnitude (up to 2e-6 measured: matmul summation orders).
* the synced gradients (``xla``, ``acis``): within 1e-5 of each leaf's
  largest magnitude of the mean of the reference's per-shard gradients.
* the synced gradients (``acis_compressed``) against the reference's
  engine run per device on the reference's per-rank gradients, and the
  EF residual per device: within 1e-5 of the largest magnitude of the
  leaf's gradient (they carry the gradients' rounding differences),
  except fewer than 1% of lanes that cross an int8 rounding tie (one
  step, absmax / 127; XLA's reciprocal multiply for ``absmax / 127``,
  ROADMAP.md §3).
* one full step against the reference's ``build_train_step_acis`` on
  ``mesh_dm`` (data 2 × model 4; the port's ``LocalMesh({"data": 2})``
  computes the whole model on each rank): the reference's own
  parameter tolerances (2.5e-2 uncompressed, 6e-2 compressed) and the
  metrics within 1e-4.  AdamW's first step moves a lane by about
  ``lr·sign(g)``, which those tolerances cannot tell from no step, so
  the update (params after minus before) is held too: every lane within
  ``2·lr`` (a sign flipped where a gradient is near zero, or an int8
  lane across a tie), and all but 1% of the lanes within ``1e-3·lr``.
* microbatches 1 / 2 / 4: the f32-accumulated gradients within 1e-5 of
  each leaf's largest magnitude of the one-shot gradients.
* ``remat`` ``"full"`` and ``"dots"``: bitwise equal to ``"none"``
  (recomputation repeats the same ops on the CPU).
* the first 30 logged ``nll`` values of ``examples/train_e2e.py --smoke``'s
  configuration (bf16 smoke model, 4 data ranks, ``acis_compressed``
  int8, AdamW with ``warmup_cosine(3e-4, 20, 30)``, ``BigramStream(seed=
  7)``, seq 32, the reference on a (4, 1) data x model mesh), the port's
  run through ``examples/torch_train_e2e.py``'s setup and loop: within
  2e-3 of the reference's curve (bf16 params rounded in different places
  by XLA's fusions; 1.0e-3 measured).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.core import make_engine as jmake_engine
from repro.data.pipeline import BigramStream as JStream
from repro.data.pipeline import DataConfig as JDataConfig
from repro.models import Model as JModel
from repro.train import loss as jloss
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro.train.loop import LoopConfig as JLoopConfig
from repro.train.loop import TrainLoop as JTrainLoop
from repro_torch import configs, interop, tree
from repro_torch.core import make_engine
from repro_torch.mesh import LocalMesh
from repro_torch.models import Model
from repro_torch.train import loss as tloss
from repro_torch.train import optimizer as topt
from repro_torch.train import step as S

from test_torch_examples import load

ARCH = "acis-100m"
LR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads a worker slow down several times over when the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32_cfgs(name=ARCH):
    return (dataclasses.replace(jconfigs.get_smoke(name),
                                param_dtype="float32", dtype="float32"),
            dataclasses.replace(configs.get_smoke(name),
                                param_dtype="float32", dtype="float32"))


def _close(got, want, rel, what="", scale=None):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# ---------------------------------------------------------------------------
# loss and optimizers
# ---------------------------------------------------------------------------

def test_cross_entropy_and_metrics_match_reference(rng):
    logits = rng.standard_normal((2, 3, 5, 11)).astype(np.float32)
    logits[0, 0, 0, [2, 7]] = 9.0                 # a tied maximum
    targets = rng.integers(0, 11, (2, 3, 5)).astype(np.int32)
    targets[0, 0, 0] = 7                          # the second of the tie
    mask = (rng.random((2, 3, 5)) > 0.3).astype(np.float32)
    for m in (None, mask):
        loss, met = tloss.cross_entropy(
            _t(logits), _t(targets), mask=None if m is None else _t(m))
        assert loss.shape == (2,)
        for r in range(2):
            jl, jm = jloss.cross_entropy(
                jnp.asarray(logits[r]), jnp.asarray(targets[r]),
                mask=None if m is None else jnp.asarray(m[r]))
            _close(loss[r], jl, 1e-6, "loss")
            for k in ("nll", "z_loss", "accuracy"):
                _close(met[k][r], jm[k], 1e-6, k)
    _, met = tloss.cross_entropy(_t(logits[0, :1, :1]), _t(targets[0, :1, :1]))
    assert float(met["accuracy"]) == 0.0          # jnp.argmax takes index 2


def _opt_tree(rng, dtype):
    return {"w": rng.standard_normal((3, 4, 5)).astype(dtype),
            "b": {"scale": rng.standard_normal((6,)).astype(dtype)},
            "m": rng.standard_normal((7, 8)).astype(dtype)}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference(rng, name):
    lr_t = topt.warmup_cosine(0.05, 2, 6)
    lr_j = jopt.warmup_cosine(0.05, 2, 6)
    o_t = topt.adamw(lr_t) if name == "adamw" else topt.adafactor(lr_t)
    o_j = jopt.adamw(lr_j) if name == "adamw" else jopt.adafactor(lr_j)
    params = _opt_tree(rng, np.float32)
    pj = jax.tree.map(jnp.asarray, params)
    pt = tree.tree_map(_t, params)
    sj, st = o_j.init(pj), o_t.init(pt)
    for step in range(4):
        g = _opt_tree(rng, np.float32)
        pj, sj = o_j.update(jax.tree.map(jnp.asarray, g), sj, pj,
                            jnp.asarray(step, jnp.int32))
        pt, st = o_t.update(tree.tree_map(_t, g), st, pt,
                            torch.tensor(step, dtype=torch.int32))
        for a, b in zip(jax.tree.leaves(pj), tree.tree_leaves(pt)):
            _close(b, a, 1e-6, f"{name} param, step {step}")
        for a, b in zip(jax.tree.leaves(sj), tree.tree_leaves(st)):
            _close(b, a, 1e-6, f"{name} state, step {step}")


def test_adamw_keeps_param_and_state_dtypes(rng):
    o = topt.adamw(1e-2, state_dtype=torch.bfloat16)
    p = {"w": torch.randn(4, 4).to(torch.bfloat16)}
    st = o.init(p)
    p2, st2 = o.update({"w": torch.randn(4, 4)}, st, p, 0)
    assert p2["w"].dtype == torch.bfloat16
    assert st2["m"]["w"].dtype == st2["v"]["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        topt.make_optimizer("sgd")
    assert topt.make_optimizer("adafactor").name == "adafactor"


def test_warmup_cosine_matches_reference():
    got = topt.warmup_cosine(3e-4, 20, 100)
    want = jopt.warmup_cosine(3e-4, 20, 100)
    for s in range(0, 120, 3):
        _close(got(torch.tensor(s, dtype=torch.int32)),
               want(jnp.asarray(s, jnp.int32)), 1e-6, f"lr at {s}")


# ---------------------------------------------------------------------------
# per-rank gradients, the synced gradients, one full step
# ---------------------------------------------------------------------------

def _tokens(vocab, n, b, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (n * b, t + 1)).astype(np.int32)


def _ref_rank_grads(jm, jp, toks, n):
    b = toks.shape[0] // n
    grad = jax.jit(jax.grad(lambda p, t: jstep._loss_fn(jm, p, t, None, None),
                            has_aux=True))
    return [grad(jp, jnp.asarray(toks[r * b:(r + 1) * b])) for r in range(n)]


@pytest.mark.parametrize("n", [2, 4])
def test_per_rank_grads_match_jax_grad(n):
    cfg_j, cfg_t = _f32_cfgs()
    jm = JModel(cfg_j)
    jp = jm.init(jax.random.key(0))
    toks = _tokens(cfg_j.vocab, n, 2, 24)
    mesh = LocalMesh({"data": n}, device="cpu")
    state = S.TrainState(interop.params_from_reference(jp), None,
                         torch.zeros((), dtype=torch.int32))
    grads, metrics = S.local_grads(Model(cfg_t), state, {"tokens": toks},
                                   mesh)
    for r, (gj, mj) in enumerate(_ref_rank_grads(jm, jp, toks, n)):
        for a, b in zip(jax.tree.leaves(gj), tree.tree_leaves(grads)):
            assert b.shape == (n,) + a.shape
            _close(b[r], a, 1e-5, f"rank {r} grad")
        for k in ("nll", "z_loss", "accuracy"):
            _close(metrics[k][r], mj[k], 1e-5, k)


def test_rank_views_are_views_and_take_each_ranks_gradient():
    p = {"w": torch.randn(3, 2)}
    v = S.rank_views(p, (4,))["w"]
    assert v.shape == (4, 3, 2) and v.stride(0) == 0 and v.is_leaf
    x = torch.arange(4.0)[:, None, None]
    (g,) = torch.autograd.grad((v * x).sum(), [v])
    assert torch.equal(g, x.expand(4, 3, 2))


def _ref_setup(mesh_dm, backend):
    cfg_j, cfg_t = _f32_cfgs()
    jm = JModel(cfg_j)
    o_j = jopt.adamw(lr=LR)
    if backend == "xla":
        eng_j = jmake_engine("xla")
    else:
        eng_j = jmake_engine(backend, inner_axis="data")
    step_j = jstep.build_train_step_acis(jm, o_j, mesh_dm, eng_j)
    st_j = jstep.init_state(jm, o_j, jax.random.key(0),
                            None if backend == "xla" else eng_j)
    return cfg_j, cfg_t, jm, step_j, st_j, eng_j


def _ref_synced_per_device(mesh_dm, eng_j, per, residual):
    """The reference engine's sync of the per-rank gradients ``per``,
    each device's own result (out spec ``P("data")``, where the step's
    ``P()`` shows one device's): ``[data, ...]`` numpy leaves."""
    stacked = jax.tree.map(lambda *g: jnp.stack(g), *per)

    def f(g, r):
        synced, _ = eng_j.gradient_sync(jax.tree.map(lambda x: x[0], g), r)
        return jax.tree.map(lambda x: x[None], synced)

    fn = jax.jit(jax.shard_map(f, mesh=mesh_dm, in_specs=(JP("data"), JP()),
                               out_specs=JP("data"), axis_names={"data"},
                               check_vma=False))
    with jax.set_mesh(mesh_dm):
        return [np.asarray(x) for x in jax.tree.leaves(fn(stacked,
                                                          residual))]


def _hold_int8_lanes(got, want, g, what):
    """``got`` against ``want`` within 1e-5 of ``g``'s largest magnitude,
    but for fewer than 1% of lanes that may be one int8 step apart."""
    gmax = float(g.abs().max())
    err = (got - _t(want)).abs()
    assert float(err.max()) <= gmax / 127 + 1e-5 * gmax, what
    assert float((err > 1e-5 * gmax).float().mean()) < 0.01, what


@pytest.mark.parametrize("backend", ["xla", "acis", "acis_compressed"])
def test_one_step_matches_reference(mesh_dm, backend):
    """The synced gradients and one full step against the reference's
    ``build_train_step_acis`` on ``mesh_dm``."""
    cfg_j, cfg_t, jm, step_j, st_j, eng_j = _ref_setup(mesh_dm, backend)
    stream = JStream(JDataConfig(vocab=cfg_j.vocab, seq_len=16,
                                 global_batch=8, seed=3))
    toks = stream.batch(0)["tokens"]
    mesh = LocalMesh({"data": 2}, device="cpu")
    model = Model(cfg_t)
    eng = make_engine(backend)
    st_t = interop.train_state_from_reference(st_j, mesh)
    before = [p.clone() for p in tree.tree_leaves(st_t.params)]
    grads, metrics = S.local_grads(model, st_t, {"tokens": toks}, mesh)
    st_t2, m_t, synced = S.sync_and_update(eng, topt.adamw(lr=LR), st_t,
                                           grads, metrics, mesh)
    # every rank holds the same synced gradients, bit for bit
    for g in tree.tree_leaves(synced):
        assert torch.equal(g[0], g[1])
    per = _ref_rank_grads(jm, st_j.params, toks, 2)
    if backend != "acis_compressed":
        for i, g in enumerate(tree.tree_leaves(synced)):
            want = np.mean([np.asarray(jax.tree.leaves(gj)[i])
                            for gj, _ in per], axis=0)
            _close(g[0], want, 1e-5, "synced grad")
    else:
        want = _ref_synced_per_device(mesh_dm, eng_j, [g for g, _ in per],
                                      st_j.ef_residual)
        for a, b, g in zip(want, tree.tree_leaves(synced),
                           tree.tree_leaves(grads)):
            assert b.shape == a.shape
            for r in range(2):
                _hold_int8_lanes(b[r], a[r], g, f"rank {r} synced grad")
    with jax.set_mesh(mesh_dm):
        st_j2, m_j = step_j(st_j, {"tokens": jnp.asarray(toks)})
    atol = 6e-2 if "compressed" in backend else 2.5e-2
    for a, b, p0 in zip(jax.tree.leaves(st_j2.params),
                        tree.tree_leaves(st_t2.params), before):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol)
        d_t = b - p0
        d_j = _t(np.asarray(a)) - p0
        assert float(d_j.abs().max()) > 0.5 * LR       # the step moved
        err = (d_t - d_j).abs()
        assert float(err.max()) <= 2 * LR * (1 + 1e-3)
        assert float((err > 1e-3 * LR).float().mean()) < 0.01
    for k in ("nll", "z_loss", "accuracy", "aux", "grad_norm"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    assert int(st_t2.step) == int(st_j2.step) == 1
    if backend == "acis_compressed":
        want = interop.train_state_from_reference(st_j2, mesh).ef_residual
        for a, b, g in zip(tree.tree_leaves(want),
                           tree.tree_leaves(st_t2.ef_residual),
                           tree.tree_leaves(grads)):
            assert b.shape == (2,) + tuple(a.shape[1:])
            _hold_int8_lanes(b, a.numpy(), g, "residual")


def test_topk_ranks_fold_in_their_own_order(rng):
    """ROADMAP.md R5: the sparse ``topk`` ring adds each rank's own
    payload first, then the ones it receives, so on three or more ranks
    the ranks' synced copies differ by roundings.  Each is bitwise the
    reference device's own (whose ``P()`` out spec hides the others),
    and the port updates from rank 0's."""
    n = 4
    base = {"a": rng.standard_normal((64, 48)),
            "b": rng.standard_normal((300,))}
    per = [{k: (v + 0.01 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in base.items()} for _ in range(n)]
    mesh_j = jax.make_mesh((n, 8 // n), ("data", "model"))
    eng_j = jmake_engine("acis_compressed", compressor="topk",
                         inner_axis="data")
    zeros = {k: jnp.zeros(v.shape, jnp.float32) for k, v in base.items()}
    want = _ref_synced_per_device(
        mesh_j, eng_j, [jax.tree.map(jnp.asarray, g) for g in per], zeros)
    mesh = LocalMesh({"data": n}, device="cpu")
    eng = make_engine("acis_compressed", compressor="topk")
    grads = {k: torch.stack([_t(g[k]) for g in per]) for k in base}
    synced, _ = eng.gradient_sync(grads, eng.init_state(grads), mesh=mesh)
    differ = False
    for a, (k, b) in zip(want, sorted(synced.items())):
        assert torch.equal(b, _t(a)), k
        m = grads[k].abs().sum(0)
        d = (b - b[0:1]).abs()
        assert bool((d <= 2.0 ** -23 * (b.abs().max(0).values + m)).all())
        differ |= not torch.equal(b, b[0:1].expand_as(b))
    assert differ


def test_reference_residual_is_one_ranks_copy(mesh_dm):
    """The divergence by design (ROADMAP.md §3): the reference's step
    returns its EF residual as a 'replicated' global array, but each
    device keeps its own rank's, so the global view holds one rank's; the
    port keeps every rank's, ``[data, ...]``."""
    cfg_j, _, _, step_j, st_j, _ = _ref_setup(mesh_dm, "acis_compressed")
    toks = _tokens(cfg_j.vocab, 2, 4, 16)
    with jax.set_mesh(mesh_dm):
        st_j2, _ = step_j(st_j, {"tokens": jnp.asarray(toks)})
    mesh = LocalMesh({"data": 2}, device="cpu")
    leaf = jax.tree.leaves(st_j2.ef_residual)[0]
    per_rank = interop.train_state_from_reference(st_j2, mesh).ef_residual
    ranks = tree.tree_leaves(per_rank)[0]
    assert not torch.equal(ranks[0], ranks[1])      # the ranks differ
    glob = _t(np.asarray(leaf))
    assert any(torch.equal(glob, ranks[r]) for r in range(2))


@pytest.mark.parametrize("microbatches", [2, 4])
def test_microbatches_match_one_shot(microbatches):
    _, cfg_t = _f32_cfgs()
    model = Model(cfg_t)
    mesh = LocalMesh({"data": 2}, device="cpu")
    st = S.init_state(model, topt.adamw(1e-2),
                      torch.Generator().manual_seed(0), device="cpu")
    toks = _tokens(cfg_t.vocab, 2, 4, 16)
    g1, m1 = S.local_grads(model, st, {"tokens": toks}, mesh)
    gm, mm = S.local_grads(model, st, {"tokens": toks}, mesh,
                           microbatches=microbatches)
    for a, b in zip(tree.tree_leaves(g1), tree.tree_leaves(gm)):
        assert b.dtype == torch.float32
        _close(b, a, 1e-5, "accumulated grad")
    for k in m1:
        _close(mm[k], m1[k], 1e-5, k)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_are_bitwise_equal_to_none(policy):
    base = dataclasses.replace(configs.get_smoke(ARCH), remat="none")
    mesh = LocalMesh({"data": 2}, device="cpu")
    toks = _tokens(base.vocab, 2, 2, 16)
    st = S.init_state(Model(base), topt.adamw(1e-2),
                      torch.Generator().manual_seed(0), device="cpu")
    g0, _ = S.local_grads(Model(base), st, {"tokens": toks}, mesh)
    g1, _ = S.local_grads(Model(dataclasses.replace(base, remat=policy)), st,
                          {"tokens": toks}, mesh)
    for a, b in zip(tree.tree_leaves(g0), tree.tree_leaves(g1)):
        assert torch.equal(a, b)


def test_init_state_threads_residual_and_arenas():
    cfg = configs.get_smoke(ARCH)
    mesh = LocalMesh({"data": 4}, device="cpu")
    eng = make_engine("acis_compressed")
    st = S.init_state(Model(cfg), topt.adamw(1e-3),
                      torch.Generator().manual_seed(0), eng, mesh=mesh,
                      arenas=True)
    for p, r in zip(tree.tree_leaves(st.params),
                    tree.tree_leaves(st.ef_residual)):
        assert r.shape == (4,) + tuple(p.shape) and r.dtype == torch.float32
    assert st.sync_arenas and all(a.shape[0] == 4 for a in st.sync_arenas)
    step = S.build_train_step_acis(Model(cfg), topt.adamw(1e-3), mesh, eng)
    toks = _tokens(cfg.vocab, 4, 1, 8)
    ptrs = [a.data_ptr() for a in st.sync_arenas]
    st2, m = step(st, {"tokens": toks})
    assert [a.data_ptr() for a in st2.sync_arenas] == ptrs
    assert int(st2.step) == 1 and set(m) == {"nll", "z_loss", "accuracy",
                                             "aux", "grad_norm"}
    with pytest.raises(ValueError, match="mesh="):
        S.init_state(Model(cfg), topt.adamw(1e-3), None, eng, device="meta")


# ---------------------------------------------------------------------------
# the end-to-end example's loss curve
# ---------------------------------------------------------------------------

E2E_STEPS, E2E_SEQ = 30, 32


def test_train_e2e_smoke_curve_matches_reference(devices):
    # train_e2e's data axis of 4; its model axis (2) only reorders the
    # reference's sums, so it is left at 1 here (4 devices, not 8)
    jmesh = jax.make_mesh((4, 1), ("data", "model"), devices=devices[:4],
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cfg_j = jconfigs.get_smoke(ARCH)
    jm = JModel(cfg_j)
    o_j = jopt.adamw(jopt.warmup_cosine(3e-4, 20, E2E_STEPS))
    eng_j = jmake_engine("acis_compressed", inner_axis="data")
    step_j = jstep.build_train_step_acis(jm, o_j, jmesh, eng_j, donate=True)
    st_j = jstep.init_state(jm, o_j, jax.random.key(0), eng_j, mesh=jmesh,
                            arenas=True)
    dcfg = dict(vocab=cfg_j.vocab, seq_len=E2E_SEQ, global_batch=8, seed=7)
    loop_j = JTrainLoop(step_j, JStream(JDataConfig(**dcfg)),
                        JLoopConfig(total_steps=E2E_STEPS, log_every=1))
    # the port's side is examples/torch_train_e2e.py's (its setup and
    # loop), started from the reference's state
    twin = load("torch_train_e2e")
    args = twin.parse_args(["--smoke", "--steps", str(E2E_STEPS), "--seq",
                            str(E2E_SEQ)])
    run = twin.setup(args, device="cpu")
    assert run.mesh.axes == {"data": 4}
    st_t = interop.train_state_from_reference(st_j, run.mesh)  # pre-donation
    with jax.set_mesh(jmesh):
        loop_j.run(st_j)
    st_t.sync_arenas = run.engine.init_arenas(tree.tree_map(
        lambda p: p.expand((4,) + tuple(p.shape)), st_t.params),
        mesh=run.mesh)
    run.state = st_t
    loop_t, _, _, _ = twin.train(args, run)
    got = [m["nll"] for m in loop_t.metrics_log]
    want = [m["nll"] for m in loop_j.metrics_log]
    assert len(got) == len(want) == E2E_STEPS
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert got[-1] < got[0]


def test_train_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = configs.get_smoke(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.init_state(Model(cfg), topt.adamw(1e-3), None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.init_state(Model(cfg), topt.adamw(1e-3), None, make_engine("acis"),
                     mesh=LocalMesh({"data": 2}))


def test_tree_walks_leave_no_reference_cycle():
    """Flattening and rebuilding a tree (every sync and update does) and
    the optimizer's walk over its state keep no tensor alive once the
    caller drops it: with the cyclic collector off, each leaf is freed at
    once.  (A recursive closure over the leaves was a reference cycle
    that held a whole step's gradients and residuals until a collection,
    up to 5 GB more peak memory in a whisper-small sync on the card.)"""
    import gc
    import weakref

    from repro_torch import tree
    from repro_torch.train import optimizer as O

    def fresh():
        return {"w": torch.ones(4), "b": [torch.zeros(2), (torch.ones(1),)]}

    gc.collect()
    gc.disable()
    try:
        t = fresh()
        refs = [weakref.ref(x) for x in tree.tree_leaves(t)]
        leaves, td = tree.tree_flatten(t)
        back = tree.tree_unflatten(td, leaves)
        found = O._leaves_at(back, td)
        assert len(found) == 3
        del t, leaves, back, found
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
