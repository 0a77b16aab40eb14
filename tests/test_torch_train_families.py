"""The training forms of the other ported families against the reference's.

* ``wkv_chunked`` against the reference's ``wkv_chunked`` (same inputs,
  f32: within 1e-5, the same chunked algebra summed in other orders) and
  against the kernel's plain version (what the token mix runs below T =
  64) within the reference's own chunked-vs-scan tolerance (2e-4,
  ``test_wkv_chunked.py``); that plain version against the reference's
  ``wkv`` scan within 1e-5.
* ``_affine_scan`` and ``rglru_block`` against the reference's (the
  log-depth scans associate differently: 1e-5 of the largest magnitude).
* the MoE aux loss and its gradient (f32 within 1e-5).
* each family's per-rank gradients (ssm, hybrid, GQA-MoE smoke configs,
  f32) against ``jax.grad`` of each rank's shard: each leaf within 1e-5
  of its largest magnitude (up to 2e-6 measured).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.models import moe as JMOE
from repro.models import rglru as JRG
from repro.models import rwkv6 as JRW
from repro.train import step as jstep
from repro_torch import configs, interop, tree
from repro_torch.kernels import rwkv6_recurrence as RK
from repro_torch.mesh import LocalMesh
from repro_torch.models import Model
from repro_torch.models import moe as TMOE
from repro_torch.models import rglru as TRG
from repro_torch.models import rwkv6 as TRW
from repro_torch.train import step as S


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads a worker slow down several times over when the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _wkv_inputs(rng, b, t, h, k, v, w_lo=0.3):
    r = rng.standard_normal((b, t, h, k)) * 0.5
    kk = rng.standard_normal((b, t, h, k)) * 0.5
    vv = rng.standard_normal((b, t, h, v)) * 0.5
    w = w_lo + (1 - w_lo) * rng.random((b, t, h, k))
    u = rng.standard_normal((h, k)) * 0.1
    return [np.asarray(z, np.float32) for z in (r, kk, vv, w, u)]


@pytest.mark.parametrize("t,chunk", [(7, 32), (32, 32), (100, 32),
                                     (33, 16)])
def test_wkv_chunked_matches_reference_and_the_scans(rng, t, chunk):
    arrs = _wkv_inputs(rng, 2, t, 2, 8, 8)
    o_j, s_j = JRW.wkv_chunked(*map(jnp.asarray, arrs), chunk=chunk)
    r, k, v, w, u = map(_t, arrs)
    o, s = TRW.wkv_chunked(r, k, v, w, u, chunk=chunk)
    _close(o, o_j, 1e-5, "o vs reference")
    _close(s, s_j, 1e-5, "state vs reference")
    o_p, s_p = RK.plain(*[z.transpose(1, 2) for z in (r, k, v, w)], u)
    o_p = o_p.transpose(1, 2)
    np.testing.assert_allclose(o.numpy(), o_p.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s.numpy(), s_p.numpy(), rtol=2e-4, atol=2e-4)
    o_jw, s_jw = JRW.wkv(*map(jnp.asarray, arrs))
    _close(o_p, o_jw, 1e-5, "plain vs the reference's wkv")
    _close(s_p, s_jw, 1e-5, "plain state vs the reference's wkv")


def test_wkv_chunked_takes_rank_dims(rng):
    arrs = _wkv_inputs(rng, 2, 40, 2, 8, 8)
    r, k, v, w, u = map(_t, arrs)
    u2 = torch.stack([u, 2 * u])
    o, s = TRW.wkv_chunked(*(z.expand(2, *z.shape) for z in (r, k, v, w)),
                           u2, chunk=16)
    for i in range(2):
        oi, si = TRW.wkv_chunked(r, k, v, w, u2[i], chunk=16)
        torch.testing.assert_close(o[i], oi, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(s[i], si, rtol=1e-6, atol=1e-6)


def test_affine_scan_and_rglru_block_match_reference(rng):
    a = rng.uniform(0.5, 1.0, (2, 37, 6)).astype(np.float32)
    b = rng.standard_normal((2, 37, 6)).astype(np.float32)
    want = jax.jit(JRG._affine_scan)(jnp.asarray(a), jnp.asarray(b),
                                     jnp.zeros((2, 6), jnp.float32))
    _close(TRG._affine_scan(_t(a), _t(b)), want, 1e-5, "scan")
    cfg_j = jconfigs.get_smoke("recurrentgemma-9b")
    p_j = JRG.init_rglru(jax.random.key(1), cfg_j.d_model, cfg_j.hybrid,
                         jnp.float32)
    u = rng.standard_normal((2, 20, cfg_j.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: JRG.rglru_block(p, x, cfg=cfg_j.hybrid))(
        p_j, jnp.asarray(u))
    p = interop.params_from_reference(p_j)
    got = TRG.rglru_block(p, _t(u), cfg=configs.get_smoke(
        "recurrentgemma-9b").hybrid)
    _close(got, want, 1e-5, "rglru_block")


def test_moe_aux_loss_and_its_gradient_match_reference(rng):
    cfg_j = jconfigs.get_smoke("qwen2-moe-a2.7b")
    cfg = configs.get_smoke("qwen2-moe-a2.7b")
    p_j = JMOE.init_moe(jax.random.key(2), cfg_j.d_model, cfg_j.moe,
                        cfg_j.activation, jnp.float32)
    x = rng.standard_normal((2, 12, cfg_j.d_model)).astype(np.float32)

    @jax.jit
    def aux_j(p):
        return JMOE.moe_ffn(p, jnp.asarray(x), cfg_j.moe,
                            cfg_j.activation)[1]

    g_j = jax.jit(jax.grad(aux_j))(p_j)
    p = tree.tree_map(lambda z: z.requires_grad_(),
                      interop.params_from_reference(p_j))
    _, aux = TMOE.moe_ffn(p, _t(x), cfg.moe, cfg.activation)
    _close(aux.detach(), aux_j(p_j), 1e-5, "aux")
    (g,) = torch.autograd.grad(aux, [p["router"]])
    _close(g, g_j["router"], 1e-5, "d aux / d router")


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "recurrentgemma-9b",
                                  "qwen2-moe-a2.7b"])
def test_family_per_rank_grads_match_jax_grad(name):
    cfg_j = dataclasses.replace(jconfigs.get_smoke(name),
                                param_dtype="float32", dtype="float32")
    cfg_t = dataclasses.replace(configs.get_smoke(name),
                                param_dtype="float32", dtype="float32")
    jm = JModel(cfg_j)
    jp = jm.init(jax.random.key(0))
    n, b, t = 2, 2, 16
    toks = np.random.default_rng(0).integers(
        0, cfg_j.vocab, (n * b, t + 1)).astype(np.int32)
    state = S.TrainState(interop.params_from_reference(jp), None,
                         torch.zeros((), dtype=torch.int32))
    grads, metrics = S.local_grads(Model(cfg_t), state, {"tokens": toks},
                                   LocalMesh({"data": n}, device="cpu"))
    grad = jax.jit(jax.grad(lambda p, x: jstep._loss_fn(jm, p, x, None, None),
                            has_aux=True))
    for r in range(n):
        gj, mj = grad(jp, jnp.asarray(toks[r * b:(r + 1) * b]))
        for a, g in zip(jax.tree.leaves(gj), tree.tree_leaves(grads)):
            _close(g[r], a, 1e-5, f"{name} rank {r}")
        for k in ("nll", "aux"):
            _close(metrics[k][r], mj[k], 1e-5, k)
