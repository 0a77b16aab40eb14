"""repro_torch top-k compression against the JAX reference.

One seeded numpy input goes to the reference (``repro.core.compression``,
its ring under ``jax.shard_map`` on 8 host devices) and to the port
(``LocalMesh({"data": 8})`` on the CPU, every rank's payload stacked in
one tensor).  Selection follows ``jax.lax.top_k``'s tie rule — the lower
index wins among equal magnitudes — and the sparse ring adds each rank's
payload in the reference's order, so every comparison here is bitwise;
the ties cases pin the rule down on data with many equal magnitudes.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import compression as jcomp
from repro_torch.core import compression as tcomp
from repro_torch.kernels import topk_accum
from repro_torch.mesh import LocalMesh

N = 8


def smap(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def assert_bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _tied(rng, shape):
    """bf16-valued data with few distinct magnitudes: a top-k cut lands
    inside a run of ties."""
    x = rng.integers(-6, 7, size=shape).astype(np.float32) * 0.25
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.mark.parametrize("size,k", [(1000, 10), (257, 256), (5, 9)])
def test_topk_compress_matches_reference(rng, size, k):
    x = rng.standard_normal((N, size)).astype(np.float32)
    with LocalMesh({"data": N}, device="cpu"):
        ti, tv = tcomp.TopK(k).compress(torch.from_numpy(x))
    assert tuple(ti.shape) == (N, min(k, size)) and ti.dtype == torch.int32
    for r in range(N):
        wi, wv = jcomp.TopK(k).compress(jnp.asarray(x[r]))
        assert_bitwise(ti[r].numpy(), np.asarray(wi))
        assert_bitwise(tv[r].numpy(), np.asarray(wv))


@pytest.mark.parametrize("k", [1, 17, 300, 999])
def test_topk_ties_break_to_the_lower_index(rng, k):
    x = _tied(rng, (1000,))
    assert len(np.unique(np.abs(x))) <= 7           # many ties at any cut
    ti, tv = tcomp.TopK(k).compress(torch.from_numpy(x))
    wi, wv = jcomp.TopK(k).compress(jnp.asarray(x))
    assert_bitwise(ti.numpy(), np.asarray(wi))
    assert_bitwise(tv.numpy(), np.asarray(wv))
    # within every run of equal magnitudes the indices ascend
    a = np.abs(x)[ti.numpy()]
    i = ti.numpy()
    same = a[1:] == a[:-1]
    assert np.all(i[1:][same] > i[:-1][same])


def test_topk_ties_per_rank_inside_a_mesh(rng):
    x = _tied(rng, (N, 640))
    with LocalMesh({"data": N}, device="cpu"):
        ti, tv = tcomp.TopK(64).compress(torch.from_numpy(x))
    for r in range(N):
        wi, wv = jcomp.TopK(64).compress(jnp.asarray(x[r]))
        assert_bitwise(ti[r].numpy(), np.asarray(wi))
        assert_bitwise(tv[r].numpy(), np.asarray(wv))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_topk_decompress_matches_reference(rng, use_kernels):
    x = rng.standard_normal((N, 6, 7)).astype(np.float32)
    tk_t, tk_j = tcomp.TopK(9), jcomp.TopK(9)
    with LocalMesh({"data": N}, device="cpu"):
        pay = tk_t.compress(torch.from_numpy(x))
        got = tk_t.decompress(pay, (6, 7), torch.float32,
                              use_kernels=use_kernels)
    assert tuple(got.shape) == (N, 6, 7)
    for r in range(N):
        want = tk_j.decompress(tk_j.compress(jnp.asarray(x[r])), (6, 7),
                               jnp.float32)
        assert_bitwise(got[r].numpy(), np.asarray(want))
    assert tk_t.wire_bytes((6, 7)) == tk_j.wire_bytes((6, 7))


def test_sparse_accumulate_matches_reference_and_leaves_dense(rng):
    dense = rng.standard_normal(40).astype(np.float32)
    idx = np.array([3, 17, 0, 39, 8], np.int32)
    vals = rng.standard_normal(5).astype(np.float32)
    td = torch.from_numpy(dense.copy())
    got = tcomp.sparse_accumulate(td, torch.from_numpy(idx),
                                  torch.from_numpy(vals))
    want = jcomp.sparse_accumulate(*map(jnp.asarray, (dense, idx, vals)))
    assert_bitwise(got.numpy(), np.asarray(want))
    assert_bitwise(td.numpy(), dense)                   # functional form
    inplace = tcomp.sparse_accumulate_(td, torch.from_numpy(idx),
                                       torch.from_numpy(vals))
    assert inplace is td
    assert_bitwise(td.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("k", [1, 12, 64])
def test_sparse_all_reduce_payloads_matches_reference(mesh8, rng, k,
                                                      use_kernels):
    """Overlapping payloads: lanes named by several ranks sum in the ring's
    order on both sides."""
    size = 96
    x = rng.standard_normal((N, size)).astype(np.float32)
    x[:, :8] *= 10.0                       # the big lanes overlap
    spec = P("data", None)

    def ref(xl):
        i, v = jcomp.TopK(k).compress(xl[0])
        return jcomp.sparse_all_reduce_payloads(i, v, "data", size)[None]

    want = np.asarray(smap(ref, mesh8, spec, spec)(jnp.asarray(x)))
    before = topk_accum.launches
    with LocalMesh({"data": N}, device="cpu"):
        i, v = tcomp.TopK(k).compress(torch.from_numpy(x))
        got = tcomp.sparse_all_reduce_payloads(i, v, "data", size,
                                               use_kernels=use_kernels)
    assert topk_accum.launches == before           # CPU: plain version
    assert_bitwise(got.numpy(), want)
    # rank r adds the payloads in the order r, r-1, ..., so a lane named
    # by several ranks may round differently on each (in the reference
    # too): the ranks agree to f32 rounding of the lane's sum of |vals|
    for r in range(1, N):
        np.testing.assert_allclose(got[r].numpy(), got[0].numpy(),
                                   rtol=0, atol=N * 2.0 ** -23
                                   * np.abs(x).max() * N)


def test_sparse_all_reduce_on_one_rank_is_the_decompress(rng):
    x = rng.standard_normal((1, 50)).astype(np.float32)
    with LocalMesh({"data": 1}, device="cpu"):
        i, v = tcomp.TopK(5).compress(torch.from_numpy(x))
        got = tcomp.sparse_all_reduce_payloads(i, v, "data", 50)
        want = tcomp.TopK(5).decompress((i, v), (50,), torch.float32)
    assert torch.equal(got, want)


def test_orthonormalize_matches_reference(rng):
    p = rng.standard_normal((32, 4)).astype(np.float32)
    got = tcomp.orthonormalize(torch.from_numpy(p)).numpy()
    want = np.asarray(jcomp.orthonormalize(jnp.asarray(p)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.T @ got, np.eye(4), atol=1e-5)
    assert tcomp.powersgd_wire_bytes((32, 16), 4) == \
        jcomp.powersgd_wire_bytes((32, 16), 4)


@pytest.mark.parametrize("rank_shape", [(N,), (2, 4)])
def test_orthonormalize_batches_over_rank_dims(rng, rank_shape):
    """Inside ``with mesh:`` PowerSGD's ``p`` is rank-stacked ``[*rank,
    n, r]``: every rank's block is orthonormalized on its own, as the
    reference does rank by rank (norms and projections sum in another
    order than XLA's, hence 1e-5)."""
    p = rng.standard_normal(rank_shape + (32, 4)).astype(np.float32)
    got = tcomp.orthonormalize(torch.from_numpy(p)).numpy()
    flat, got_flat = p.reshape(-1, 32, 4), got.reshape(-1, 32, 4)
    for r in range(flat.shape[0]):
        want = np.asarray(jcomp.orthonormalize(jnp.asarray(flat[r])))
        np.testing.assert_allclose(got_flat[r], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_flat[r].T @ got_flat[r], np.eye(4),
                                   atol=1e-5)
