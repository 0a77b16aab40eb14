"""End-to-end behaviour of the port as a whole: the twin of
``tests/test_system.py``, at its sizes, on the CPU.

One test drives the full stack the way ``examples/torch_train_e2e.py``
does — data pipeline → model → explicit ACiS compressed gradient sync →
optimizer → checkpoint → resume — and asserts the observable outcomes
(loss descends, resume is bit-exact).  The others cover the serve path
and a compiled switch program used inside a larger computation that
autograd differentiates.  The reference's ``mesh_dm`` is (data 2, model
4) and its acis step splits the batch over ``data`` only, so the port
trains on ``LocalMesh({"data": 2})``.
"""

import numpy as np
import torch

from repro_torch import configs, tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import make_engine
from repro_torch.data.pipeline import BigramStream, DataConfig
from repro_torch.mesh import P, LocalMesh
from repro_torch.models import Model
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.step import build_train_step_acis, init_state

CPU = "cpu"


def _equal(a, b) -> bool:
    la, lb = tree.tree_leaves(a), tree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_system_train_acis_compressed_end_to_end(tmp_path):
    """Train the smoke model for 30 steps through the ACiS compressed
    transport with a checkpoint every 10; the loss must descend, the
    step-30 checkpoint must restore the final state exactly, and a run
    resumed from the step-20 one must end bit for bit where the straight
    run did."""
    cfg = configs.get_smoke("acis-100m")
    model = Model(cfg)
    optimizer = opt_lib.adamw(1e-2)
    engine = make_engine("acis_compressed", inner_axis="data")
    mesh = LocalMesh({"data": 2}, device=CPU)
    step = build_train_step_acis(model, optimizer, mesh, engine)

    def fresh():
        return init_state(model, optimizer, torch.Generator().manual_seed(0),
                          engine, mesh=mesh)

    stream = BigramStream(DataConfig(vocab=cfg.vocab, seq_len=32,
                                     global_batch=8, seed=11))
    d = str(tmp_path / "ck")
    loop = TrainLoop(step, stream, LoopConfig(
        total_steps=30, ckpt_every=10, ckpt_dir=d, log_every=5))
    final = loop.run(fresh())

    nlls = [m["nll"] for m in loop.metrics_log]
    assert nlls[-1] < nlls[0] - 0.2, nlls
    # EF residual is part of the checkpointed state (look-aside memory)
    assert final.ef_residual is not None
    assert tree.tree_leaves(final.ef_residual)[0].shape[0] == 2

    # restore the step-30 checkpoint: the state must match exactly
    loop2 = TrainLoop(step, stream, LoopConfig(
        total_steps=30, ckpt_every=10, ckpt_dir=d, log_every=5))
    state2 = loop2.maybe_restore(fresh())
    assert int(state2.step) == 30
    for name in ("params", "opt", "ef_residual"):
        assert _equal(getattr(final, name), getattr(state2, name)), name

    # resume from step 20 and run to 30: bit for bit the straight run
    mid, at, _ = ckpt.restore(d, fresh(), step=20)
    assert at == int(mid.step) == 20
    resumed = TrainLoop(step, stream, LoopConfig(
        total_steps=30, log_every=5)).run(mid)
    for name in ("params", "opt", "ef_residual"):
        assert _equal(getattr(final, name), getattr(resumed, name)), name


def test_system_serve_end_to_end(rng):
    """Submit → continuous-batch decode → all requests complete."""
    from repro_torch.serve import Request, ServeEngine

    cfg = configs.get_smoke("acis-100m")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(3), device=CPU)
    eng = ServeEngine(model, params, slots=2, max_seq=48)
    for i in range(3):
        eng.submit(Request(rid=i,
                           prompt=rng.integers(0, cfg.vocab,
                                               3 + i).astype(np.int32),
                           max_new_tokens=5))
    done = eng.run_to_completion()
    assert len(done) == 3
    assert all(len(c.tokens) == 5 for c in done)
    assert [c.rid for c in done] == [0, 1, 2]
    # (per-request oracle equivalence: tests/test_torch_serving.py)


def test_system_fused_program_in_training_context(rng):
    """A compiled switch program as a building block inside a larger
    computation (the 'CGRA binary carried as an argument' pattern),
    differentiated by autograd through its rings and scan."""
    from repro_torch.core import (AllGather, Scan, SwitchProgram,
                                  compile_rank_local)

    prog = SwitchProgram([AllGather(), Scan(), AllGather()], "fem")
    compiled = compile_rank_local(prog, "data")
    mesh = LocalMesh({"data": 8}, device=CPU)
    x = rng.standard_normal(16).astype(np.float32)
    xr = mesh.shard(torch.from_numpy(x), P("data")).requires_grad_()

    with mesh:
        local = xr * 2.0
        (fem,) = compiled(local)        # fused in-network prefix sum
        out = fem.sum(-1) + local.sum(-1)       # one value a rank
    want = np.cumsum(2 * x).sum() + (2 * x).reshape(8, 2).sum(1)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-4)

    # d(sum over ranks)/dx_j: 8 ranks each see 2·(16 - j) from the scan's
    # sum, and rank j // 2 adds 2 for its own element
    out.sum().backward()
    grad = 8 * 2.0 * (16 - np.arange(16)) + 2.0
    np.testing.assert_allclose(xr.grad.reshape(-1).numpy(), grad,
                               rtol=1e-6)
