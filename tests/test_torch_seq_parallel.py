"""The sequence-parallel RG-LRU scan (``rglru_scan_sp``): every rank a
contiguous chunk of T, the chunks joined by the exclusive rank scan of
the affine monoid — against the reference's under ``shard_map`` over the
8 host devices, the unsplit scan and a float64 recurrence, within
``sp_tolerance`` (the f32 bound of the split evaluation)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.models.rglru import rglru_scan_sp as ref_scan_sp
from repro_torch.kernels import chunk_scan as CS
from repro_torch.mesh import LocalMesh, PartitionSpec as P
from repro_torch.models import rglru as RG

N, B, T, W = 8, 2, 256, 16


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.85, 0.999, (B, T, W)).astype(np.float32)
    b = rng.standard_normal((B, T, W)).astype(np.float32)
    return a, b


def _port(a, b, **kw):
    mesh = LocalMesh({"data": N}, device="cpu")
    spec = P(None, "data", None)
    with mesh:
        h = RG.rglru_scan_sp(mesh.shard(torch.from_numpy(a), spec),
                             mesh.shard(torch.from_numpy(b), spec), "data",
                             **kw)
    return mesh.unshard(h, spec)


def test_rglru_scan_sp_matches_the_reference_and_the_unsplit_scan(mesh8):
    a, b = _inputs()
    got = _port(a, b).double()
    spec = JP(None, "data", None)
    fn = jax.jit(jax.shard_map(lambda x, y: ref_scan_sp(x, y, "data"),
                               mesh=mesh8, in_specs=(spec, spec),
                               out_specs=spec, check_vma=False))
    want = torch.from_numpy(np.asarray(fn(jnp.asarray(a), jnp.asarray(b)),
                                       np.float64))
    exact, tol = RG.sp_tolerance(torch.from_numpy(a), torch.from_numpy(b), N)
    assert torch.all((got - exact).abs() <= tol)
    assert torch.all((want - exact).abs() <= tol)
    assert torch.all((got - want).abs() <= 2 * tol)
    # the unsplit scan (the kernel's plain version, in time order)
    whole = CS.rglru_plain(torch.from_numpy(a), torch.from_numpy(b)).double()
    _, tol_whole = CS.rglru_tolerance(torch.from_numpy(a),
                                      torch.from_numpy(b))
    assert torch.all((whole - exact).abs() <= tol_whole)
    assert torch.all((got - whole).abs() <= tol + tol_whole)
    # a dropped carry is far outside the bound
    mesh = LocalMesh({"data": N}, device="cpu")
    with mesh:
        local = RG._affine_scan(*(mesh.shard(torch.from_numpy(z),
                                             P(None, "data", None))
                                  for z in (a, b)))
    no_carry = mesh.unshard(local, P(None, "data", None)).double()
    assert not torch.all((no_carry - exact).abs() <= tol)


def test_rglru_scan_sp_gradients_match_the_unsplit_scan():
    """Under autograd the split scan (``_affine_scan`` per chunk, no
    kernel) gives the unsplit scan's gradients."""
    a, b = _inputs(1)
    mesh = LocalMesh({"data": N}, device="cpu")
    spec = P(None, "data", None)
    at = mesh.shard(torch.from_numpy(a).double(), spec).requires_grad_()
    bt = mesh.shard(torch.from_numpy(b).double(), spec).requires_grad_()
    with mesh:
        h = RG.rglru_scan_sp(at, bt, "data")
    w = torch.linspace(-1, 1, T * W, dtype=torch.float64).reshape(1, T, W)
    (mesh.unshard(h, spec) * w).sum().backward()
    a2 = torch.from_numpy(a).double().requires_grad_()
    b2 = torch.from_numpy(b).double().requires_grad_()
    (RG._affine_scan(a2, b2) * w).sum().backward()
    np.testing.assert_allclose(mesh.unshard(at.grad, spec).numpy(),
                               a2.grad.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(mesh.unshard(bt.grad, spec).numpy(),
                               b2.grad.numpy(), rtol=1e-9, atol=1e-9)
