"""The port's checkpoints and fault-tolerant loop against the reference's.

Checkpoints share the reference's on-disk layout (``manifest.json`` with
``keystr`` leaf paths, ``leaf_NNNNN.npy``, bf16 as ``uint16`` views,
sha256[:16] checksums, an atomic ``LATEST``), so a checkpoint written by
either package restores in the other bit for bit.  The loop resumes a
killed run bit-exactly, EF residual included, on the CPU.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.models import Model as JModel
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs, interop, tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import make_engine
from repro_torch.data.pipeline import BigramStream, DataConfig
from repro_torch.mesh import LocalMesh
from repro_torch.models import Model
from repro_torch.train import optimizer as topt
from repro_torch.train import step as S
from repro_torch.train.loop import (LoopConfig, Preempted, TrainLoop,
                                    run_with_restarts)

ARCH = "acis-100m"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads a worker slow down several times over when the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    t = torch.as_tensor(t) if not torch.is_tensor(t) else t
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _equal_trees(a, b):
    la, lb = tree.tree_leaves(a), tree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


def _state(backend="acis_compressed", n=2, seed=0):
    cfg = configs.get_smoke(ARCH)
    mesh = LocalMesh({"data": n}, device="cpu")
    eng = make_engine(backend)
    st = S.init_state(Model(cfg), topt.adamw(1e-2),
                      torch.Generator().manual_seed(seed), eng, mesh=mesh)
    return cfg, mesh, eng, st


def test_checkpoint_roundtrip(tmp_path):
    cfg, mesh, eng, st = _state()
    step = S.build_train_step_acis(Model(cfg), topt.adamw(1e-2), mesh, eng)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 9))
    st, _ = step(st, {"tokens": toks})          # a nonzero residual
    d = str(tmp_path / "ck")
    ckpt.save(d, 7, st, extra={"note": "x"})
    like = tree.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                               device="meta"),
                         [st.params, st.opt, st.ef_residual])
    like = S.TrainState(like[0], like[1], torch.empty((), dtype=torch.int32,
                                                      device="meta"), like[2])
    got, stepno, extra = ckpt.restore(d, like)
    assert stepno == 7 and extra == {"note": "x"} and ckpt.latest_step(d) == 7
    assert int(got.step) == 1 and got.step.dtype == torch.int32
    _equal_trees([st.params, st.opt, st.ef_residual],
                 [got.params, got.opt, got.ef_residual])
    assert any(r.abs().max() > 0 for r in tree.tree_leaves(got.ef_residual))
    assert got.params["embed"].dtype == torch.bfloat16


def test_checkpoint_detects_corruption(tmp_path):
    _, _, _, st = _state()
    d = str(tmp_path / "ck")
    path = ckpt.save(d, 1, st)
    victim = sorted(f for f in os.listdir(path) if f.endswith(".npy"))[1]
    arr = np.load(os.path.join(path, victim))
    arr.flat[0] += 1
    np.save(os.path.join(path, victim), arr)
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(d, st)
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(d, {"nope": torch.zeros(1)})


def test_keep_last_trims_old_steps(tmp_path):
    d = str(tmp_path / "ck")
    for s in range(1, 6):
        ckpt.save(d, s, {"w": torch.full((2,), float(s))}, keep_last=2)
    assert sorted(f for f in os.listdir(d) if f.startswith("step_")) == \
        ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(d) == 5
    got, _, _ = ckpt.restore(d, {"w": torch.zeros(2)}, step=4)
    assert torch.equal(got["w"], torch.full((2,), 4.0))
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def _ref_state():
    cfg = jconfigs.get_smoke(ARCH)
    o = jopt.adamw(lr=1e-2)
    st = jstep.init_state(JModel(cfg), o, jax.random.key(0))
    # a trained-looking optimizer state, so every leaf has distinct bits
    st.opt = jax.tree.map(lambda x: x + 0.25, st.opt)
    st.step = jnp.asarray(3, jnp.int32)
    return st


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    st_j = _ref_state()
    d = str(tmp_path / "ck")
    jckpt.save(d, 3, st_j)
    mesh = LocalMesh({"data": 2}, device="cpu")
    like = interop.train_state_from_reference(st_j, mesh)
    like = dataclasses.replace(like, params=tree.tree_map(
        torch.zeros_like, like.params))
    got, stepno, _ = ckpt.restore(d, like)
    assert stepno == 3 and int(got.step) == 3
    want = interop.train_state_from_reference(st_j, mesh)
    _equal_trees([want.params, want.opt], [got.params, got.opt])
    # the same leaf paths, dtypes and bf16 bits on disk
    manifest = json.load(open(os.path.join(d, "step_00000003",
                                           "manifest.json")))
    ours = [p for p, _ in ckpt._leaf_paths(got)]
    assert ours == [m["path"] for m in manifest["leaves"]]
    assert {m["dtype"] for m in manifest["leaves"]} == {"bfloat16", "float32",
                                                         "int32"}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    cfg, mesh, eng, st = _state(backend="acis")
    st.step = torch.tensor(5, dtype=torch.int32)
    d = str(tmp_path / "ck")
    ckpt.save(d, 5, st)
    st_j = _ref_state()
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        st_j)
    got, stepno, _ = jckpt.restore(d, like)
    assert stepno == 5 and int(np.asarray(got.step)) == 5
    want = interop.train_state_to_reference(st)
    for a, b in zip(jax.tree.leaves([got.params, got.opt]),
                    jax.tree.leaves([want["params"], want["opt"]])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(
            np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


def _loop(d, mesh, fail_at=None, total=10, backend="acis_compressed"):
    cfg = configs.get_smoke(ARCH)
    model = Model(cfg)
    o = topt.adamw(1e-2)
    eng = make_engine(backend)
    st = S.init_state(model, o, torch.Generator().manual_seed(0), eng,
                      mesh=mesh, arenas=True)
    stream = BigramStream(DataConfig(vocab=cfg.vocab, seq_len=16,
                                     global_batch=4, seed=3))
    loop = TrainLoop(S.build_train_step_acis(model, o, mesh, eng), stream,
                     LoopConfig(total_steps=total, ckpt_every=5, ckpt_dir=d,
                                fail_at_step=fail_at, log_every=100))
    return loop, st


def test_training_resumes_bit_exact_after_crash(tmp_path):
    """Kill at step 6, restart from the step-5 checkpoint: the final state
    (params, optimizer state, EF residual) equals an uninterrupted run."""
    mesh = LocalMesh({"data": 2}, device="cpu")
    ref_loop, st = _loop(None, mesh)
    ref = ref_loop.run(st)
    d = str(tmp_path / "ck")
    calls = {"n": 0}

    def factory():
        calls["n"] += 1
        return _loop(d, mesh, fail_at=6 if calls["n"] == 1 else None)

    final, restarts = run_with_restarts(factory)
    assert restarts == 1 and int(final.step) == 10
    _equal_trees([ref.params, ref.opt, ref.ef_residual],
                 [final.params, final.opt, final.ef_residual])


def test_run_with_restarts_gives_up_and_preemption_checkpoints(tmp_path):
    mesh = LocalMesh({"data": 2}, device="cpu")
    d = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected fault"):
        run_with_restarts(lambda: _loop(d, mesh, fail_at=2, total=4),
                          max_restarts=1)
    d2 = str(tmp_path / "ck2")
    loop, st = _loop(d2, mesh, total=4)
    loop.request_preempt()
    with pytest.raises(Preempted):
        loop.run(st)
    assert ckpt.latest_step(d2) == 1
    loop2, st2 = _loop(d2, mesh, total=4)
    st2 = loop2.maybe_restore(st2)
    assert int(st2.step) == 1 and st2.sync_arenas is not None
    assert int(loop2.run(st2).step) == 4
