"""The GSPMD train step of the port (``build_train_step_gspmd``: FSDP × TP
on a LocalMesh, native collectives) against the reference's
``build_train_step_gspmd`` and the port's acis step with the ``xla``
engine — the counterparts of ``test_train_substrate.py``'s train-step
tests on the smoke config and the 2 × 4 ``mesh_dm`` — plus the optimizer
layouts, Adafactor on shards, checkpoints across layouts and the
collective log's adjoint pairs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import Model as RefModel
from repro.train import optimizer as ref_opt
from repro.train import step as ref_step
from repro_torch import configs, interop, tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import make_engine
from repro_torch.data.pipeline import BigramStream, DataConfig
from repro_torch.mesh import LocalMesh
from repro_torch.models import Model
from repro_torch.sharding import native, rules
from repro_torch.train import optimizer as O
from repro_torch.train import step as S

ARCH = "acis-100m"


def _cfg(f32=False):
    cfg = configs.get_smoke(ARCH)
    if f32:
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  dtype="float32")
    return cfg


def _mesh(data=2, model=4):
    return LocalMesh({"data": data, "model": model}, device="cpu")


def _setup(mesh, microbatches=1, f32=False, opt=None):
    cfg = _cfg(f32)
    model = Model(cfg)
    opt = opt or O.adamw(lr=1e-2)
    step = S.build_train_step_gspmd(model, opt, mesh,
                                    microbatches=microbatches)
    state = step.place_state(S.init_state(
        model, opt, torch.Generator().manual_seed(0), device="cpu"))
    return cfg, model, opt, step, state


def _stream(cfg, batch=8):
    return BigramStream(DataConfig(vocab=cfg.vocab, seq_len=16,
                                   global_batch=batch, seed=3))


def test_gspmd_train_step_descends():
    mesh = _mesh()
    cfg, model, opt, step, state = _setup(mesh)
    stream = _stream(cfg)
    losses = []
    for i in range(12):
        state, m = step(state, stream.batch(i))
        losses.append(float(m["nll"]))
    assert losses[-1] < losses[0] - 0.2, losses
    assert int(state.step) == 12
    # every leaf sits in its param_specs layout
    shapes = model.param_shapes()
    for x, s, y in zip(tree.tree_leaves(shapes),
                       rules.spec_leaves(step.state_specs.params),
                       tree.tree_leaves(state.params)):
        rules.constrain(y, mesh, s, tuple(x.shape))


@pytest.mark.parametrize("microbatches", [2, 4])
def test_gspmd_microbatching_equivalent(microbatches):
    """Grad accumulation matches the single-shot gradient (same batch)."""
    mesh = _mesh()
    cfg, _, _, step1, state = _setup(mesh, microbatches=1)
    _, _, _, stepm, _ = _setup(mesh, microbatches=microbatches)
    batch = _stream(cfg).batch(0)
    s1, m1 = step1(state, batch)
    sm, mm = stepm(state, batch)
    np.testing.assert_allclose(float(m1["nll"]), float(mm["nll"]), rtol=1e-3)
    # the reference's check: the first leaf (embed) within 2e-2 (bf16
    # params, Adam moves isolated elements by up to ~lr on either side)
    a = tree.tree_leaves(step1.unshard_state(s1).params)[0]
    b = tree.tree_leaves(stepm.unshard_state(sm).params)[0]
    np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                               atol=2e-2)


def _ref_leaves(t):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(t)]


def _against_the_reference(mesh_dm, arch, metrics):
    """Three f32 steps of ``arch``'s smoke config from one state carried
    across: the reference's GSPMD step (XLA's partitioner on 2 × 4 host
    devices) and the port's (native collectives on LocalMesh({"data": 2,
    "model": 4})), ``metrics`` within 1e-5 relative on every step, the
    params within atol 2.5e-2 and more than 99% of them within 1e-5.
    Returns the port's step."""
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              param_dtype="float32", dtype="float32")
    rcfg = dataclasses.replace(ref_configs.get_smoke(arch),
                               param_dtype="float32", dtype="float32")
    rmodel = RefModel(rcfg)
    ropt = ref_opt.adamw(lr=1e-2)
    rstep = ref_step.build_train_step_gspmd(rmodel, ropt, mesh_dm,
                                            donate=False)
    rstate = ref_step.init_state(rmodel, ropt, jax.random.key(0), None)
    mesh = _mesh()
    step = S.build_train_step_gspmd(Model(cfg), O.adamw(lr=1e-2), mesh)
    state = interop.train_state_from_reference(rstate, mesh,
                                               specs=step.state_specs)
    stream = _stream(cfg)
    with jax.set_mesh(mesh_dm):
        for i in range(3):
            b = stream.batch(i)
            rstate, rm = rstep(rstate, {"tokens": jnp.asarray(b["tokens"])})
            state, m = step(state, b)
            for k in metrics:
                np.testing.assert_allclose(float(m[k]), float(rm[k]),
                                           rtol=1e-5, err_msg=k)
    got = [x.numpy() for x in tree.tree_leaves(
        step.unshard_state(state).params)]
    want = _ref_leaves(rstate.params)
    # Adam's rsqrt turns reduction-order differences on near-zero grads
    # into up to ~lr per step for isolated elements (the reference's own
    # acis-vs-xla reasoning); the functional check is the nll above
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2.5e-2)
    close = np.mean([np.mean(np.abs(g - w) <= 1e-5) for g, w in
                     zip(got, want)])
    assert close > 0.99, close
    return step


def test_gspmd_step_matches_the_reference(mesh_dm):
    """acis-100m: nll and grad_norm (see :func:`_against_the_reference`)."""
    _against_the_reference(mesh_dm, ARCH, ("nll", "grad_norm"))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-236b"])
def test_gspmd_moe_step_matches_the_reference(mesh_dm, arch):
    """The MoE families (GQA and MLA attention): their 4 experts compute
    expert-parallel over the 4 ``model`` ranks, and the load-balance
    loss takes the global batch's means, as the reference's global
    program does (per-rank means put ``aux`` 2e-3 off and, through
    Adam, the nll 1e-3 off by step 3); nll, grad_norm and aux."""
    step = _against_the_reference(mesh_dm, arch, ("nll", "grad_norm", "aux"))
    assert step.expert_parallel


def test_gspmd_step_matches_the_acis_xla_step():
    """The reference's acis-vs-xla claim on the port: the GSPMD baseline
    and the acis step with the ``xla`` engine train alike (atol 2.5e-2,
    nll within 0.05, the reference's tolerances)."""
    mesh = _mesh()
    cfg, model, opt, step_x, state_x = _setup(mesh, f32=True)
    amesh = LocalMesh({"data": 8}, device="cpu")
    step_a = S.build_train_step_acis(model, opt, amesh, make_engine("xla"))
    state_a = S.init_state(model, opt, torch.Generator().manual_seed(0),
                           device="cpu")
    stream = _stream(cfg)
    for i in range(3):
        state_x, mx = step_x(state_x, stream.batch(i))
        state_a, ma = step_a(state_a, stream.batch(i))
    for lx, la in zip(tree.tree_leaves(step_x.unshard_state(state_x).params),
                      tree.tree_leaves(state_a.params)):
        np.testing.assert_allclose(lx.numpy(), la.numpy(), atol=2.5e-2)
    np.testing.assert_allclose(float(mx["nll"]), float(ma["nll"]), atol=0.05)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_opt_specs_match_the_reference(name):
    from jax.sharding import AbstractMesh
    for sizes, names in (((2, 4), ("data", "model")),
                         ((16, 16), ("data", "model"))):
        mesh = LocalMesh(dict(zip(names, sizes)), device="meta")
        amesh = AbstractMesh(sizes, names)
        for arch in configs.names():
            shapes = Model(configs.get(arch)).param_shapes()
            opt = O.make_optimizer(name)
            got = S._opt_specs(opt.init(shapes), rules.param_specs(
                shapes, mesh))
            rshapes = RefModel(ref_configs.get(arch)).param_shapes()
            ropt = ref_opt.make_optimizer(name)
            want = ref_step._opt_specs(
                jax.eval_shape(ropt.init, rshapes),
                ref_step.rules.param_specs(rshapes, amesh))
            flat, _ = jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))
            norm = [tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                          else e for e in s) for _, s in flat]
            port = [tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                          else e for e in s)
                    for s in rules.spec_leaves(got)]
            assert port == norm, (arch, sizes, name)


def test_adafactor_on_shards_equals_the_unsharded_update():
    """Adafactor's row / column statistics and its RMS clip, averaged over
    the ranks that split each leaf, give the global update."""
    mesh = _mesh()
    opt = O.adafactor(lr=1e-2)
    cfg, model, _, step, state = _setup(mesh, f32=True, opt=opt)
    b = _stream(cfg).batch(0)
    # one step first, so the statistics are non-zero going in
    state, _ = step(state, b)
    g, metrics = step.grads(state, _stream(cfg).batch(1))
    new, _ = step.update(state, g, metrics)
    whole = step.unshard_state(state)
    g_whole = rules.unshard_tree(g, step.state_specs.params, mesh)
    want_p, want_o = opt.update(g_whole, whole.opt, whole.params,
                                whole.step)
    got = step.unshard_state(new)
    for a, w in zip(tree.tree_leaves(got.params), tree.tree_leaves(want_p)):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7)
    for a, w in zip(tree.tree_leaves(got.opt), tree.tree_leaves(want_o)):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-12)


def test_checkpoint_restores_across_layouts(tmp_path):
    """An acis-step (global) checkpoint restores into the GSPMD layout,
    and a GSPMD checkpoint back into the global one, bit for bit."""
    mesh = _mesh()
    cfg, model, opt, step, state = _setup(mesh)
    glob = S.init_state(model, opt, torch.Generator().manual_seed(0),
                        device="cpu")
    like = model.param_shapes()
    d1 = str(tmp_path / "acis")
    ckpt.save(d1, 3, glob.params)
    restored, n, _ = ckpt.restore(d1, like, specs=step.state_specs.params,
                                  mesh=mesh)
    assert n == 3
    for a, b in zip(tree.tree_leaves(state.params),
                    tree.tree_leaves(restored)):
        assert torch.equal(a, b)
    state, _ = step(state, _stream(cfg).batch(0))
    d2 = str(tmp_path / "gspmd")
    ckpt.save(d2, 4, state.params, specs=step.state_specs.params, mesh=mesh)
    back, _, _ = ckpt.restore(d2, like, device="cpu")
    for a, b in zip(tree.tree_leaves(step.unshard_state(state).params),
                    tree.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("axes", [(2, 4), (4, 2)])
def test_backward_collectives_are_the_forward_adjoints(axes):
    """Every forward all-gather has its reduce-scatter in the backward
    (the same axes, the shapes transposed) and every forward all-reduce
    its all-reduce; the other backward all-reduces are the replicated
    leaves' (one a leaf the layout replicates, one a period for a leaf
    of the stacked layers, which are gathered a period at a time)."""
    mesh = _mesh(*axes)
    cfg, model, opt, step, state = _setup(mesh)
    with native.counting() as log:
        step(state, _stream(cfg).batch(0))
    fwd = [e for e in log.entries if e.direction == "fwd"]
    bwd = [e for e in log.entries if e.direction == "bwd"]
    ag = sorted((e.axes, e.in_shape, e.out_shape) for e in fwd
                if e.kind == "all-gather")
    rs = sorted((e.axes, e.out_shape, e.in_shape) for e in bwd
                if e.kind == "reduce-scatter")
    assert ag and ag == rs
    ar_f = sorted((e.axes, e.out_shape) for e in fwd
                  if e.kind == "all-reduce")
    ar_b = sorted((e.axes, e.out_shape) for e in bwd
                  if e.kind == "all-reduce")
    rest = list(ar_b)
    for x in ar_f:
        rest.remove(x)
    used = [{a for e in s for a in S._axes_of(e)} | {a for e in c
                                                     for a in S._axes_of(e)}
            for s, c in zip(rules.spec_leaves(step.state_specs.params),
                            step.compute_specs)]
    pairs = rules.leaves_with_paths(step.state_specs.params)
    periods = [x.shape[0] if rules._is_stacked(rules._path_str(path)) else 1
               for (path, _), x in zip(pairs, tree.tree_leaves(
                   model.param_shapes()))]
    replicated = sum(n for u, n in zip(used, periods)
                     if set(mesh.axis_names) - u)
    assert len(rest) == replicated
    assert step.tp_plan == ((False, True) if axes == (2, 4) else (True, True))
    # the byte counts are per rank, as the roofline reads them
    assert log.total_bytes == sum(e.bytes for e in log.entries) > 0


def test_backward_on_another_thread_reports_to_the_forward_log():
    """On the card autograd runs the backward on its own device thread,
    where the log's context variable is unset: the adjoints report to
    the log their forward saw."""
    import threading

    mesh = _mesh()
    x = torch.randn(2, 4, 3, 8, requires_grad=True)
    with native.counting() as log:
        y = native.all_reduce(native.all_gather(x, mesh, ("model",), 1),
                              mesh, ("data",))
    done = []
    t = threading.Thread(target=lambda: done.append(
        torch.autograd.grad(y.sum(), x)))
    t.start()
    t.join()
    kinds = [(e.kind, e.direction) for e in log.entries]
    assert kinds == [("all-gather", "fwd"), ("all-reduce", "fwd"),
                     ("all-reduce", "bwd"), ("reduce-scatter", "bwd")]
    assert done and done[0][0].shape == x.shape


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", [ARCH, "qwen2-moe-a2.7b"])
def test_gspmd_remat_recomputes_under_the_hook(arch, remat):
    """A rematerialized period is recomputed in the backward, outside the
    forward's ``with tensor_parallel(...)``: it must run under the
    step's hook again (the row-parallel all-reduces, the expert-parallel
    slice and gather), or the split periods recompute partial sums.
    The gradients equal those without remat, bitwise.  On 4 × 2 both
    configs split their attention over ``model``.  The period's params
    are gathered inside the remat region, so the recompute gathers them
    again (none is kept for the backward), with one reduce-scatter each
    all the same."""
    mesh = _mesh(4, 2)
    base = dataclasses.replace(configs.get_smoke(arch),
                               param_dtype="float32", dtype="float32")
    opt = O.adamw(lr=1e-2)
    state = S.init_state(Model(base), opt, torch.Generator().manual_seed(0),
                         device="cpu")
    batch = _stream(base).batch(0)
    grads, counts = [], []
    for policy in ("none", remat):
        step = S.build_train_step_gspmd(
            Model(dataclasses.replace(base, remat=policy)), opt, mesh)
        with native.counting() as log:
            g, _ = step.grads(step.place_state(state), batch)
        grads.append(tree.tree_leaves(g))
        counts.append({k: v["count"] for k, v in log.summary().items()})
    assert step.tp_plan[0]
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    none, rem = counts
    assert rem["reduce-scatter/bwd"] == none["reduce-scatter/bwd"]
    assert rem["all-gather/fwd"] > none["all-gather/fwd"]
