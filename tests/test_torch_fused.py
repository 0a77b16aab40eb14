"""repro_torch Type 4 fused collectives against the JAX reference.

The cases of ``test_core_fused.py``: one seeded numpy input goes to
``repro.core.fused`` under ``jax.shard_map`` on the conftest meshes and to
``repro_torch.core.fused`` on a ``LocalMesh`` on the CPU (rank dims in
front).  Data movement, ring folds and integer-valued scans are bitwise
(the port walks the reference's hops and chunks in the same order).  A
scan of random floats is not: ``jnp.cumsum`` on the CPU lowers to an
associative scan and ``torch.cumsum`` sums in order, so each output is
held within the worst-case rounding of a sum in any order,
``i·2^-24·Σ_{t≤i}|x_t|`` per side.  Matmuls sum their products in
another order (XLA's dot against PyTorch's): they are held within the
reference test's own tolerance.

The collective matmuls run on ``data:2 × model:4`` over ``model``, the
second mesh axis, with every one of the 8 ranks holding its own block, so
the ring, ``take``/``put`` and ``axis_index`` are exercised on an axis
that is not the leading rank dim.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import fused as jfused
from repro.core import ring as jring
from repro.core.types import ADD as JADD, MAX as JMAX
from repro_torch.core import fused as tfused
from repro_torch.core import ring as tring
from repro_torch.core.types import ADD as TADD, MAX as TMAX
from repro_torch.mesh import LocalMesh

N = 8
DM = {"data": 2, "model": 4}


def smap(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def scan_bound(x: np.ndarray) -> np.ndarray:
    """Worst-case rounding of a float32 prefix sum in any order, for the
    global scan of the rank-major concatenation ``x`` (first order: each
    of the i additions behind output i rounds by at most 2^-24 of a
    partial sum, which is at most Σ_{t≤i}|x_t|)."""
    flat = np.abs(x.astype(np.float64)).reshape(x.shape[0], -1)
    i = np.arange(1, flat.shape[0] + 1)[:, None]
    return (i * 2.0 ** -24 * np.cumsum(flat, axis=0)).reshape(x.shape)


def scan_data(rng, shape, kind):
    if kind == "integer":        # every partial sum exact in f32
        return rng.integers(-3, 4, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def dm_spec(a):
    return P("data", "model", *([None] * (a.ndim - 2)))


# ---------------------------------------------------------------------------
# Fig. 5: allgather_op_allgather and the generalized scan + gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("kind", ["integer", "normal"])
@pytest.mark.parametrize("local", [(16,), (16, 3)])
def test_allgather_op_allgather_matches_reference(mesh8, rng, local, kind,
                                                  use_kernels):
    x = scan_data(rng, (N,) + local, kind)

    def ref(xl):
        return jfused.allgather_op_allgather(xl[0], "data")[None]

    spec = P("data", *([None] * len(local)))
    want = np.asarray(smap(ref, mesh8, spec, spec)(jnp.asarray(x)))
    with LocalMesh({"data": N}, device="cpu"):
        got = tfused.allgather_op_allgather(torch.from_numpy(x), "data",
                                            use_kernels=use_kernels).numpy()
    assert got.shape == (N, N * local[0]) + local[1:]
    exact = np.cumsum(x.reshape((N * local[0],) + local[1:])
                      .astype(np.float64), axis=0)
    for r in range(N):               # every rank holds the whole scan
        if kind == "integer":
            bitwise(got[r], want[r])
            np.testing.assert_array_equal(got[r], exact)
        else:
            bound = scan_bound(x.reshape(exact.shape))
            assert np.all(np.abs(got[r] - want[r]) <= 2 * bound)
            assert np.all(np.abs(got[r] - exact) <= bound)


def test_allgather_op_allgather_baseline_matches_reference(mesh8, rng):
    x = rng.standard_normal((N * 16,)).astype(np.float32)

    def base(xl):
        return jfused.allgather_op_allgather_baseline(xl, "data")

    want = np.asarray(smap(base, mesh8, P("data"), P(None))(jnp.asarray(x)))
    with LocalMesh({"data": N}, device="cpu"):
        got = tfused.allgather_op_allgather_baseline(
            torch.from_numpy(x.reshape(N, 16)), "data").numpy()
    bound = scan_bound(x)
    for r in range(N):
        assert np.all(np.abs(got[r] - want) <= 2 * bound)
        np.testing.assert_allclose(got[r], np.cumsum(x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("monoid", ["add", "max"])
def test_scan_then_allgather_matches_reference(mesh8, rng, monoid,
                                               exclusive):
    """The generic rank scan: per-rank blocks combined in rank order with
    any monoid (max here), then gathered — every fold is the reference's,
    so it is bitwise on any data."""
    x = rng.standard_normal((N, 5, 2)).astype(np.float32)
    jm, tm = {"add": (JADD, TADD), "max": (JMAX, TMAX)}[monoid]

    def ref(xl):
        return jfused.scan_then_allgather(xl[0], "data", jm,
                                          exclusive=exclusive)[None]

    spec = P("data", None, None)
    want = smap(ref, mesh8, spec, spec)(jnp.asarray(x))
    with LocalMesh({"data": N}, device="cpu"):
        got = tfused.scan_then_allgather(torch.from_numpy(x), "data", tm,
                                         exclusive=exclusive)
    bitwise(got.numpy(), want)


# ---------------------------------------------------------------------------
# NAS IS: allreduce + alltoall on one schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["fused_allreduce_alltoall",
                                "allreduce_alltoall_baseline"])
def test_allreduce_alltoall_matches_reference(mesh8, rng, fn):
    hist = rng.integers(0, 10, (N, 32)).astype(np.float32)
    keys = rng.standard_normal((N, N * 4)).astype(np.float32)

    def ref(h, k):
        hh, kk = getattr(jfused, fn)(h[0], k[0], "data")
        return hh[None], kk[None]

    spec = (P("data", None), P("data", None))
    wh, wk = smap(ref, mesh8, spec, spec)(jnp.asarray(hist),
                                          jnp.asarray(keys))
    with LocalMesh({"data": N}, device="cpu"):
        th, tk = getattr(tfused, fn)(torch.from_numpy(hist),
                                     torch.from_numpy(keys), "data")
    bitwise(th.numpy(), wh)
    bitwise(tk.numpy(), wk)
    # oracle: the histogram sum everywhere, key chunk j of rank r at rank j
    np.testing.assert_array_equal(th.numpy(), np.broadcast_to(
        hist.sum(0), (N, 32)))
    np.testing.assert_array_equal(
        tk.numpy(), keys.reshape(N, N, 4).transpose(1, 0, 2).reshape(N, -1))


def test_fused_allreduce_alltoall_on_one_rank_is_identity(rng):
    hist = torch.from_numpy(rng.standard_normal((1, 3)).astype(np.float32))
    keys = torch.from_numpy(rng.standard_normal((1, 6)).astype(np.float32))
    with LocalMesh({"data": 1}, device="cpu"):
        h, k = tfused.fused_allreduce_alltoall(hist, keys, "data")
    assert h is hist and k is keys


# ---------------------------------------------------------------------------
# MapReduce fusions
# ---------------------------------------------------------------------------

def test_map_reduce_scatter_matches_reference(mesh8, rng):
    x = rng.standard_normal((N, N * 8)).astype(np.float32)

    def ref(xl):
        return jfused.map_reduce_scatter(xl[0], "data", jnp.square)[None]

    want = smap(ref, mesh8, P("data", None), P("data", None))(jnp.asarray(x))
    with LocalMesh({"data": N}, device="cpu"):
        got = tfused.map_reduce_scatter(torch.from_numpy(x), "data",
                                        torch.square)
    bitwise(got.numpy(), want)
    np.testing.assert_allclose(got.numpy().reshape(-1),
                               np.square(x).sum(axis=0), rtol=1e-4,
                               atol=1e-4)


def test_allgather_map_applied_in_flight(mesh8, rng):
    x = rng.standard_normal((N, 4)).astype(np.float32)
    calls = []

    def triple(c):
        calls.append(tuple(c.shape))
        return c * 3.0

    def ref(xl):
        return jfused.allgather_map(xl[0], "data", lambda c: c * 3.0)[None]

    want = smap(ref, mesh8, P("data", None), P("data", None))(jnp.asarray(x))
    with LocalMesh({"data": N}, device="cpu"):
        got = tfused.allgather_map(torch.from_numpy(x), "data", triple)
    bitwise(got.numpy(), want)
    # applied once, to every rank's own chunk, before the hops
    assert calls == [(N, 4)]
    for i in range(N):
        np.testing.assert_array_equal(got.numpy()[i], (3.0 * x).reshape(-1))


# ---------------------------------------------------------------------------
# the second mesh axis: ring, take/put and axis_index over "model"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["ring_all_gather",
                                      "ring_reduce_scatter",
                                      "ring_all_to_all", "rank_prefix_scan"])
def test_ring_schedules_over_the_second_axis(mesh_dm, rng, schedule):
    x = rng.standard_normal((2, 4, 8, 3)).astype(np.float32)

    def ref(xl):
        return getattr(jring, schedule)(xl[0, 0], "model")[None, None]

    want = smap(ref, mesh_dm, dm_spec(x), dm_spec(x))(jnp.asarray(x))
    with LocalMesh(DM, device="cpu"):
        got = getattr(tring, schedule)(torch.from_numpy(x), "model")
    bitwise(got.numpy(), want)


def test_axis_index_take_put_over_the_second_axis(mesh_dm):
    mesh = LocalMesh(DM, device="cpu")
    i = mesh.axis_index("model")
    assert tuple(i.shape) == (1, 4)
    xs = torch.arange(2 * 4 * 4 * 3, dtype=torch.float32).reshape(2, 4, 4, 3)
    got = mesh.take(xs, (i + 1) % 4)
    for d in range(2):
        for m in range(4):
            assert torch.equal(got[d, m], xs[d, m, (m + 1) % 4])
    out = torch.zeros_like(xs)
    mesh.put(out, i, got)
    for d in range(2):
        for m in range(4):
            assert torch.equal(out[d, m, m], xs[d, m, (m + 1) % 4])
            others = [j for j in range(4) if j != m]
            assert not out[d, m, others].any()

    def ref(xl):
        return jax.lax.axis_index("model").reshape(1, 1) + 0 * xl[..., 0, 0]

    ranks = smap(ref, mesh_dm, P("data", "model", None, None),
                 P("data", "model"))(jnp.asarray(xs.numpy()))
    np.testing.assert_array_equal(np.asarray(ranks),
                                  i.expand(2, 4).numpy())


# ---------------------------------------------------------------------------
# collective matmul, over the second axis of data:2 × model:4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["allgather_matmul",
                                "allgather_matmul_baseline"])
def test_allgather_matmul_matches_reference(mesh_dm, rng, fn):
    m_loc, k, n_loc = 6, 16, 8
    x = rng.standard_normal((2, 4, m_loc, k)).astype(np.float32)
    w = rng.standard_normal((2, 4, k, n_loc)).astype(np.float32)

    def ref(xl, wl):
        return getattr(jfused, fn)(xl[0, 0], wl[0, 0], "model")[None, None]

    want = np.asarray(smap(ref, mesh_dm, (dm_spec(x), dm_spec(w)),
                           dm_spec(x))(jnp.asarray(x), jnp.asarray(w)))
    with LocalMesh(DM, device="cpu"):
        got = getattr(tfused, fn)(torch.from_numpy(x), torch.from_numpy(w),
                                  "model").numpy()
    assert got.shape == (2, 4, 4 * m_loc, n_loc)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for d in range(2):               # oracle: the gathered rows @ w_local
        full = x[d].reshape(4 * m_loc, k)
        for m in range(4):
            np.testing.assert_allclose(got[d, m], full @ w[d, m],
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fn", ["matmul_reduce_scatter",
                                "matmul_reduce_scatter_baseline"])
def test_matmul_reduce_scatter_matches_reference(mesh_dm, rng, fn):
    m, k_loc, n_cols = 6, 8, 32
    x = rng.standard_normal((2, 4, m, k_loc)).astype(np.float32)
    w = rng.standard_normal((2, 4, k_loc, n_cols)).astype(np.float32)

    def ref(xl, wl):
        return getattr(jfused, fn)(xl[0, 0], wl[0, 0], "model")[None, None]

    want = np.asarray(smap(ref, mesh_dm, (dm_spec(x), dm_spec(w)),
                           dm_spec(x))(jnp.asarray(x), jnp.asarray(w)))
    with LocalMesh(DM, device="cpu"):
        got = getattr(tfused, fn)(torch.from_numpy(x), torch.from_numpy(w),
                                  "model").numpy()
    assert got.shape == (2, 4, m, n_cols // 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    nc = n_cols // 4
    for d in range(2):               # oracle: rank j owns column block j
        total = sum(x[d, r] @ w[d, r] for r in range(4))
        for j in range(4):
            np.testing.assert_allclose(got[d, j], total[:, j * nc:(j + 1) * nc],
                                       rtol=1e-4, atol=1e-4)


def test_collective_matmul_differentiable(mesh_dm, rng):
    """The fused matmul must be trainable: autograd through the rotations
    and per-rank block writes gives ``jax.grad``'s gradient (the
    reference test's setup: x row-sharded, W column-sharded over
    ``model``, data-replicated)."""
    m_loc, k, n_loc = 4, 8, 4
    x = rng.standard_normal((4 * m_loc, k)).astype(np.float32)
    w = rng.standard_normal((k, 4 * n_loc)).astype(np.float32)

    def loss(wj):
        def f(xl, wl):
            y = jfused.allgather_matmul(xl, wl, "model")
            return jnp.sum(y ** 2).reshape(1)
        part = jax.shard_map(f, mesh=mesh_dm,
                             in_specs=(P("model", None), P(None, "model")),
                             out_specs=P("model"), check_vma=False)
        return part(jnp.asarray(x), wj).sum()

    want = np.asarray(jax.grad(loss)(jnp.asarray(w)))

    wt = torch.from_numpy(w).requires_grad_(True)
    xr = torch.from_numpy(x).reshape(4, m_loc, k).expand(2, 4, m_loc, k)
    wr = wt.reshape(k, 4, n_loc).permute(1, 0, 2).expand(2, 4, k, n_loc)
    with LocalMesh(DM, device="cpu"):
        y = tfused.allgather_matmul(xr, wr, "model")
    # out_specs P("model"): one data replica's four model ranks
    (y[0] ** 2).sum().backward()
    got = wt.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, 2 * x.T @ (x @ w), rtol=1e-3, atol=1e-3)
