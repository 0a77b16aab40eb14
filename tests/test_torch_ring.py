"""repro_torch ring schedules and collectives against the JAX reference.

One seeded numpy input goes to the reference (8 host devices under
``jax.shard_map``) and to the port (``LocalMesh({"data": 8})`` on the
CPU).  Every f32 add/max/min schedule walks the same chunks in the same
fold order, so the results must be bitwise equal; the few comparisons
that are not bitwise state why.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import collectives as jcoll
from repro.core import ring as jring
from repro.core import types as jtypes
from repro_torch.core import collectives as tcoll
from repro_torch.core import ring as tring
from repro_torch.core import types as ttypes
from repro_torch.kernels import quant_combine as tqc
from repro_torch.mesh import LocalMesh

# ``repro.core.wire`` is shadowed by the traced ``wire`` op on the package
jwire = importlib.import_module("repro.core.wire")
twire = importlib.import_module("repro_torch.core.wire")

N = 8
MONOIDS = ["add", "max", "min"]


def smap(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def ref_ranks(fn, mesh8, x):
    """Run the reference ``fn`` on rank r's ``x[r]``; returns [N, ...]."""
    spec = P("data", *([None] * (x.ndim - 1)))
    return np.asarray(smap(lambda xl: fn(xl[0])[None], mesh8, spec, spec)(
        jnp.asarray(x)))


def port_ranks(fn, x):
    """Run the port's ``fn`` on the rank-stacked ``x`` ([N, ...])."""
    with LocalMesh({"data": N}, device="cpu"):
        return fn(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def assert_bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("chunk", [16, 5])
@pytest.mark.parametrize("mono", MONOIDS)
def test_reduce_scatter_bitwise(mesh8, rng, mono, chunk):
    x = rng.standard_normal((N, N * chunk)).astype(np.float32)
    want = ref_ranks(lambda v: jring.ring_reduce_scatter(
        v, "data", jtypes.TYPE1_MONOIDS[mono]), mesh8, x)
    got = port_ranks(lambda v: tring.ring_reduce_scatter(
        v, "data", ttypes.TYPE1_MONOIDS[mono]), x)
    assert_bitwise(got, want)


@pytest.mark.parametrize("hop_map", [False, True])
def test_all_gather_bitwise(mesh8, rng, hop_map):
    x = rng.standard_normal((N, 4, 3)).astype(np.float32)
    hm = (lambda c: 2.0 * c + 1.0) if hop_map else None
    want = ref_ranks(lambda v: jring.ring_all_gather(v, "data", hop_map=hm),
                     mesh8, x)
    got = port_ranks(lambda v: tring.ring_all_gather(v, "data", hop_map=hm),
                     x)
    assert_bitwise(got, want)


@pytest.mark.parametrize("latency_optimal", [False, True])
@pytest.mark.parametrize("shape", [(33,), (8, 5), (128,), (13,)])
@pytest.mark.parametrize("mono", MONOIDS)
def test_all_reduce_both_schedules_bitwise(mesh8, rng, mono, shape,
                                           latency_optimal):
    x = rng.standard_normal((N,) + shape).astype(np.float32)
    want = ref_ranks(lambda v: jring.ring_all_reduce(
        v, "data", jtypes.TYPE1_MONOIDS[mono],
        latency_optimal=latency_optimal), mesh8, x)
    got = port_ranks(lambda v: tring.ring_all_reduce(
        v, "data", ttypes.TYPE1_MONOIDS[mono],
        latency_optimal=latency_optimal), x)
    assert_bitwise(got, want)


@pytest.mark.parametrize("mono", ["max", "min"])
def test_ragged_nonadd_reduce_bitwise_correct(mesh8, rng, mono):
    """A bandwidth ring over a size it must pad: the pad lanes carry the
    monoid identity, so all-negative max / all-positive min survive."""
    sign = -1.0 if mono == "max" else 1.0
    x = sign * np.abs(rng.standard_normal((N, 13))).astype(np.float32) - 1.0
    want = ref_ranks(lambda v: jring.ring_all_reduce(
        v, "data", jtypes.TYPE1_MONOIDS[mono]), mesh8, x)
    got = port_ranks(lambda v: tring.ring_all_reduce(
        v, "data", ttypes.TYPE1_MONOIDS[mono]), x)
    assert_bitwise(got, want)
    np.testing.assert_array_equal(got[0], x.max(0) if mono == "max"
                                  else x.min(0))


@pytest.mark.parametrize("root", [0, 3, 7])
@pytest.mark.parametrize("kind", ["ring", "tree"])
def test_broadcast_bitwise(mesh8, rng, root, kind):
    x = rng.standard_normal((N, 6)).astype(np.float32)
    jf = jring.ring_broadcast if kind == "ring" else jring.tree_broadcast
    tf = tring.ring_broadcast if kind == "ring" else tring.tree_broadcast
    want = ref_ranks(lambda v: jf(v, "data", root), mesh8, x)
    got = port_ranks(lambda v: tf(v, "data", root), x)
    assert_bitwise(got, want)


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("mono", MONOIDS)
def test_rank_prefix_scan_bitwise(mesh8, rng, mono, exclusive):
    x = rng.standard_normal((N, 5)).astype(np.float32)
    want = ref_ranks(lambda v: jring.rank_prefix_scan(
        v, "data", jtypes.TYPE1_MONOIDS[mono], exclusive=exclusive),
        mesh8, x)
    got = port_ranks(lambda v: tring.rank_prefix_scan(
        v, "data", ttypes.TYPE1_MONOIDS[mono], exclusive=exclusive), x)
    assert_bitwise(got, want)


def test_rank_prefix_scan_noncommutative(mesh8):
    """Matrix-product scan: rank order must be respected.  Matmul sums
    in library-chosen order, so this one is allclose (f32, 1e-5)."""
    rng = np.random.default_rng(1)
    x = (np.eye(3, dtype=np.float32)[None].repeat(N, 0)
         + 0.1 * rng.standard_normal((N, 3, 3)).astype(np.float32))
    jm = jtypes.Monoid("matmul", lambda a, b: a @ b,
                       lambda s: jnp.broadcast_to(jnp.eye(3, dtype=s.dtype),
                                                  s.shape),
                       commutative=False)
    tm = ttypes.Monoid("matmul", lambda a, b: a @ b,
                       lambda s: torch.eye(3, dtype=s.dtype).expand(
                           tuple(s.shape)).clone(), commutative=False)
    want = ref_ranks(lambda v: jring.rank_prefix_scan(v, "data", jm),
                     mesh8, x)
    got = port_ranks(lambda v: tring.rank_prefix_scan(v, "data", tm), x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_all_to_all_bitwise(mesh8, rng):
    x = rng.standard_normal((N, N * 3, 2)).astype(np.float32)
    want = ref_ranks(lambda v: jring.ring_all_to_all(v, "data"), mesh8, x)
    got = port_ranks(lambda v: tring.ring_all_to_all(v, "data"), x)
    assert_bitwise(got, want)


def test_axis_size_one_degenerates():
    x = np.arange(8.0, dtype=np.float32)[None]
    with LocalMesh({"data": 1}, device="cpu"):
        t = torch.from_numpy(x)
        out = tring.ring_all_reduce(t, "data") \
            + tring.ring_all_gather(t, "data") \
            + tring.rank_prefix_scan(t, "data")
    np.testing.assert_array_equal(out.numpy(), 3 * x)


def test_ring_needs_an_active_mesh():
    with pytest.raises(RuntimeError, match="no active mesh"):
        tring.ring_all_reduce(torch.zeros(8, 4), "data")


# ---------------------------------------------------------------------------
# collectives: both backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["acis", "xla"])
@pytest.mark.parametrize("mono", MONOIDS)
def test_collective_all_reduce_backends(mesh8, rng, backend, mono):
    """acis rings are bitwise; the xla baseline sums in another order than
    XLA's psum (allclose, f32 at 1e-6)."""
    x = rng.standard_normal((N, 37)).astype(np.float32)
    want = ref_ranks(lambda v: jcoll.all_reduce(
        v, "data", jtypes.TYPE1_MONOIDS[mono], backend=backend), mesh8, x)
    got = port_ranks(lambda v: tcoll.all_reduce(
        v, "data", ttypes.TYPE1_MONOIDS[mono], backend=backend), x)
    if backend == "acis" or mono != "add":
        assert_bitwise(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("backend", ["acis", "xla"])
def test_collective_reduce_scatter_and_gather(mesh8, rng, backend):
    x = rng.standard_normal((N, N * 6)).astype(np.float32)
    want = ref_ranks(lambda v: jcoll.all_gather(jcoll.reduce_scatter(
        v, "data", backend=backend), "data", backend=backend), mesh8, x)
    got = port_ranks(lambda v: tcoll.all_gather(tcoll.reduce_scatter(
        v, "data", backend=backend), "data", backend=backend), x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if backend == "acis":
        assert_bitwise(got, want)


@pytest.mark.parametrize("backend", ["acis", "xla"])
def test_collective_all_to_all_and_broadcast(mesh8, rng, backend):
    x = rng.standard_normal((N, N * 2, 3)).astype(np.float32)
    want = ref_ranks(lambda v: jcoll.broadcast(jcoll.all_to_all(
        v, "data", backend=backend), "data", 5, backend=backend), mesh8, x)
    got = port_ranks(lambda v: tcoll.broadcast(tcoll.all_to_all(
        v, "data", backend=backend), "data", 5, backend=backend), x)
    assert_bitwise(got, want)


def test_xla_backend_rejects_user_defined_ops():
    with LocalMesh({"data": N}, device="cpu"):
        with pytest.raises(ValueError, match="Type 1"):
            tcoll.all_reduce(torch.zeros(N, 4), "data", ttypes.PROD,
                             backend="xla")
        with pytest.raises(ValueError, match="codecs"):
            tcoll.all_reduce(torch.zeros(N, 4), "data", ttypes.ADD,
                             backend="xla", codec=twire.BF16)


@pytest.mark.parametrize("codec", ["bf16", "fp8"])
def test_cast_codec_all_reduce_bitwise(mesh8, rng, codec):
    """Cast codecs ring in the wire dtype; each add rounds once in both
    frameworks, so the decoded f32 result is bitwise equal."""
    x = rng.standard_normal((N, 40)).astype(np.float32)
    want = ref_ranks(lambda v: jcoll.all_reduce(
        v, "data", codec=jwire.CODECS[codec]), mesh8, x)
    got = port_ranks(lambda v: tcoll.all_reduce(
        v, "data", codec=twire.CODECS[codec]), x)
    assert_bitwise(got, want)


def test_int8_codec_all_reduce_encoded_domain(mesh8, rng):
    """The encoded-domain RS∘AG walk (dequant-add-requant per hop).  The
    reference's XLA may contract ``q*s + q*s`` into a fused multiply-add,
    which rounds once where PyTorch rounds twice, so a requantized lane
    can land one int8 step away: allclose at one quantization step of the
    result's scale."""
    x = rng.standard_normal((N, 700)).astype(np.float32)
    want = ref_ranks(lambda v: jcoll.all_reduce(
        v, "data", codec=jwire.int8_codec()), mesh8, x)
    got = port_ranks(lambda v: tcoll.all_reduce(
        v, "data", codec=twire.int8_codec()), x)
    step = np.abs(x.sum(0)).max() / 127.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1.01 * step)
    np.testing.assert_allclose(got[0], x.sum(0), atol=N * step)
    for r in range(1, N):               # every rank decodes the same walk
        assert_bitwise(got[r], got[0])


def test_allreduce_argmax_with_payload_bitwise(mesh8, rng):
    """Type 2 monoid over a (value, payload) pytree, latency ring."""
    vals = rng.standard_normal((N, 12)).astype(np.float32)
    payload = rng.standard_normal((N, 12)).astype(np.float32)

    def jf(v, p):
        ov, op = jcoll.all_reduce((v[0], p[0]), "data",
                                  jtypes.ARGMAX_WITH_PAYLOAD,
                                  latency_optimal=True)
        return ov[None], op[None]

    spec = P("data", None)
    want = smap(jf, mesh8, (spec, spec), (spec, spec))(
        jnp.asarray(vals), jnp.asarray(payload))
    with LocalMesh({"data": N}, device="cpu"):
        got = tcoll.all_reduce(
            (torch.from_numpy(vals), torch.from_numpy(payload)), "data",
            ttypes.ARGMAX_WITH_PAYLOAD, latency_optimal=True)
    for g, w in zip(got, want):
        assert_bitwise(g.numpy(), np.asarray(w))


def test_allreduce_welford_variance(mesh8, rng):
    """Type 2 'stateful datatype': distributed mean/var in one pass.  The
    merge divides and multiplies in one expression, which XLA may fuse
    differently: allclose at f32 1e-6 relative."""
    data = rng.standard_normal((N, 64)).astype(np.float32)

    def jf(xl):
        x = xl[0]
        n, m, s = jcoll.all_reduce(
            (jnp.ones_like(x), x, jnp.zeros_like(x)), "data",
            jtypes.WELFORD, latency_optimal=True)
        return m[None], (s / n)[None]

    spec = P("data", None)
    wm, wv = smap(jf, mesh8, spec, (spec, spec))(jnp.asarray(data))
    with LocalMesh({"data": N}, device="cpu"):
        x = torch.from_numpy(data)
        n, m, s = tcoll.all_reduce(
            (torch.ones_like(x), x, torch.zeros_like(x)), "data",
            ttypes.WELFORD, latency_optimal=True)
    np.testing.assert_allclose(m.numpy(), np.asarray(wm), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose((s / n).numpy(), np.asarray(wv), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(m.numpy()[0], data.mean(0), atol=1e-5)


# ---------------------------------------------------------------------------
# the fused ring hop: the registered Type 1 kernels' hook carries a
# ``fused_hop`` form, which the reduce-scatter takes on CUDA tensors; CPU
# tensors keep the transport loop (shift, take, combine), the fused hop's
# plain version
# ---------------------------------------------------------------------------

DM = {"data": 2, "model": 4}


def _counted_hop(mono, calls):
    """The registered kernel hook of ``mono``, recording in ``calls`` the
    form the ring calls for each hop: ``"step"`` (the hook itself, in the
    transport loop) or ``"fused"`` (its ``fused_hop`` form)."""
    from repro_torch.core import switchops

    hop = switchops.hop_kernel(mono)

    def step(incoming, local):
        calls.append("step")
        return hop(incoming, local)

    def fused(buf, xs, s, **kw):
        calls.append("fused")
        return hop.fused_hop(buf, xs, s, **kw)
    step.fused_hop = fused
    return step


@pytest.mark.parametrize("schedule", ["ring_reduce_scatter",
                                      "ring_all_reduce"])
@pytest.mark.parametrize("mono", MONOIDS)
def test_fused_hop_plain_version_bitwise_on_one_axis(mesh8, rng, mono,
                                                     schedule):
    from repro_torch.kernels import fused_combine as tfc

    x = rng.standard_normal((N, N * 6)).astype(np.float32)
    want = ref_ranks(lambda v: getattr(jring, schedule)(
        v, "data", jtypes.TYPE1_MONOIDS[mono]), mesh8, x)
    calls, before = [], (tfc.launches, tfc.hop_launches)
    got = port_ranks(lambda v: getattr(tring, schedule)(
        v, "data", ttypes.TYPE1_MONOIDS[mono],
        hop_combine=_counted_hop(mono, calls)), x)
    assert_bitwise(got, want)
    assert calls == ["step"] * (N - 1)          # the transport loop
    assert (tfc.launches, tfc.hop_launches) == before  # no launch on the CPU


@pytest.mark.parametrize("schedule", ["ring_reduce_scatter",
                                      "ring_all_reduce"])
@pytest.mark.parametrize("mono", MONOIDS)
def test_fused_hop_plain_version_bitwise_over_the_second_axis(
        mesh_dm, rng, mono, schedule):
    x = rng.standard_normal((2, 4, 4 * 5, 3)).astype(np.float32)
    spec = P("data", "model", None, None)

    def ref(xl):
        return getattr(jring, schedule)(
            xl[0, 0], "model", jtypes.TYPE1_MONOIDS[mono])[None, None]
    want = smap(ref, mesh_dm, spec, spec)(jnp.asarray(x))
    calls = []
    with LocalMesh(DM, device="cpu"):
        got = getattr(tring, schedule)(
            torch.from_numpy(x), "model", ttypes.TYPE1_MONOIDS[mono],
            hop_combine=_counted_hop(mono, calls))
    assert_bitwise(got.numpy(), want)
    assert calls == ["step"] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("axes,axis", [({"data": 8}, "data"),
                                       (DM, "model")])
@pytest.mark.parametrize("mono", MONOIDS)
def test_fused_hop_ring_matches_the_transport_loop_on_card(rng, mono, axes,
                                                           axis):
    """On CUDA tensors the ring takes the fused form once per hop, with
    the same result bit for bit as the transport loop on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card (chip_smoke.py checks them there)")
    shape = tuple(axes.values())
    x = torch.from_numpy(rng.standard_normal(
        shape + (axes[axis] * 5, 3)).astype(np.float32))
    results = {}
    for dev in ("cpu", "cuda"):
        calls = []
        with LocalMesh(axes, device=dev):
            results[dev] = tring.ring_reduce_scatter(
                x.to(dev), axis, ttypes.TYPE1_MONOIDS[mono],
                hop_combine=_counted_hop(mono, calls)).cpu()
        want = "step" if dev == "cpu" else "fused"
        assert calls == [want] * (axes[axis] - 1)
    assert torch.equal(results["cuda"], results["cpu"])


# ---------------------------------------------------------------------------
# the fused encoded hop: under use_kernels the int8 codec's combine carries
# a ``fused_hop`` form (``quant_combine.quant_hop``), which the encoded
# RS∘AG walk takes on CUDA leaves; CPU leaves keep the transport loop
# (shift, take, quant_combine), whose step the hop's plain version computes
# ---------------------------------------------------------------------------

PD = {"pod": 2, "data": 4}


def _quant_inputs(rng, rank_shape, n, rows):
    """Random int8 payloads and f32 scales of every rank's partial sum
    (``[*rank, rows, 256]``) and input chunks (``[*rank, n, rows,
    256]``), with .5 ties planted: each buf row peaks at 127 with scale
    0.5, each chunk row at 127 with scale 0.5, and lanes 1-6 sum to ±0.5,
    ±1.5, ±2.5 in half the rows."""
    def q(shape):
        return rng.integers(-127, 128, shape + (256,)).astype(np.int8)

    q_buf, q_xs = q(rank_shape + (rows,)), q(rank_shape + (n, rows))
    s_buf = rng.uniform(0.1, 2, rank_shape + (rows,)).astype(np.float32)
    s_xs = rng.uniform(0.1, 2, rank_shape + (n, rows)).astype(np.float32)
    tie = slice(0, rows, 2)
    for qq, ss in ((q_buf, s_buf), (q_xs, s_xs)):
        qq[..., tie, :] = np.clip(qq[..., tie, :], -60, 60)
        qq[..., tie, 0] = 127
        ss[..., tie] = 0.5
    q_buf[..., tie, 1:7] = [1, 2, 3, -1, -2, -3]
    q_xs[..., tie, 1:7] = [0, 1, 2, 0, -1, -2]
    return [torch.from_numpy(a) for a in (q_buf, s_buf, q_xs, s_xs)]


@pytest.mark.parametrize("axes,axis", [({"data": N}, "data"), (PD, "data")])
@pytest.mark.parametrize("rows", [1, 6])
def test_quant_hop_plain_is_the_transport_step(rng, axes, axis, rows):
    """``quant_hop``'s plain version (and the wrapper on CPU tensors, which
    runs it) equals the step the encoded ring takes through the transport,
    ``quant_combine(shift(buf, 1), take(xs, (i - 2 - s) % n))``, bit for
    bit at every hop ``s``, on one axis and over the second of two."""
    mesh = LocalMesh(axes, device="cpu")
    n, i = axes[axis], mesh.axis_index(axis)
    q_buf, s_buf, q_xs, s_xs = _quant_inputs(rng, mesh.rank_shape, n, rows)
    before = (tqc.launches, tqc.hop_launches)
    kw = dict(dim=mesh.dim(axis), rank_ndim=mesh.rank_ndim)
    for s in range(n - 1):
        c = (i - 2 - s) % n
        want = tqc.quant_combine(mesh.shift(q_buf, axis, 1),
                                 mesh.shift(s_buf, axis, 1),
                                 mesh.take(q_xs, c), mesh.take(s_xs, c))
        for got in (tqc.hop_plain(q_buf, s_buf, q_xs, s_xs, s, **kw),
                    tqc.quant_hop(q_buf, s_buf, q_xs, s_xs, s, **kw)):
            assert_bitwise(got[0].numpy(), want[0].numpy())
            assert_bitwise(got[1].numpy(), want[1].numpy())
    assert (tqc.launches, tqc.hop_launches) == before   # CPU: no launch


def _counted_codec(calls):
    """The kernels' int8 codec, recording in ``calls`` the form the
    encoded ring calls for each hop: ``"step"`` (the combine, in the
    transport loop) or ``"fused"`` (its ``fused_hop`` form)."""
    codec = twire.int8_codec(use_kernels=True)
    comb = codec.combine_encoded

    def step(incoming, local):
        calls.append("step")
        return comb(incoming, local)

    def fused(buf, xs, s, **kw):
        calls.append("fused")
        return comb.fused_hop(buf, xs, s, **kw)
    step.fused_hop = fused
    return dataclasses.replace(codec, combine_encoded=step)


def test_int8_codec_kernels_walk_the_transport_loop_on_cpu(mesh8, rng):
    """The kernels' int8 codec on CPU tensors: one combine per hop in the
    transport loop, nothing launched, bitwise equal to the plain codec and
    as close to the reference as the plain codec is (one int8 step: XLA
    contracts ``q*s + q*s``)."""
    x = rng.standard_normal((N, 700)).astype(np.float32)
    want = ref_ranks(lambda v: jcoll.all_reduce(
        v, "data", codec=jwire.int8_codec()), mesh8, x)
    calls, before = [], (tqc.launches, tqc.hop_launches)
    got = port_ranks(lambda v: tcoll.all_reduce(
        v, "data", codec=_counted_codec(calls)), x)
    plain = port_ranks(lambda v: tcoll.all_reduce(
        v, "data", codec=twire.int8_codec()), x)
    assert calls == ["step"] * (N - 1)
    assert (tqc.launches, tqc.hop_launches) == before
    assert_bitwise(got, plain)
    step = np.abs(x.sum(0)).max() / 127.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1.01 * step)


def test_int8_codec_kernels_over_the_second_axis_on_cpu(rng):
    """Over the second axis of ``{"pod": 2, "data": 4}`` each pod's walk
    is the one-axis walk of its 4 ranks, bit for bit."""
    x = rng.standard_normal((2, 4, 600)).astype(np.float32)
    calls = []
    with LocalMesh(PD, device="cpu"):
        got = tcoll.all_reduce(torch.from_numpy(x), "data",
                               codec=_counted_codec(calls))
    assert calls == ["step"] * 3
    for p in range(2):
        with LocalMesh({"data": 4}, device="cpu"):
            want = tcoll.all_reduce(torch.from_numpy(x[p]), "data",
                                    codec=twire.int8_codec())
        assert_bitwise(got[p].numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("axes,axis", [({"data": N}, "data"), (PD, "data")])
def test_int8_codec_fused_hop_matches_the_transport_loop_on_card(rng, axes,
                                                                 axis):
    """On CUDA leaves the encoded ring takes the fused form once per hop,
    with the same result bit for bit as the transport loop on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the "
                    "card (chip_smoke.py checks them there)")
    shape = tuple(axes.values())
    x = torch.from_numpy(rng.standard_normal(shape + (3000,)).astype(
        np.float32))
    results = {}
    for dev in ("cpu", "cuda"):
        calls = []
        with LocalMesh(axes, device=dev):
            results[dev] = tcoll.all_reduce(
                x.to(dev), axis, codec=_counted_codec(calls)).cpu()
        want = "step" if dev == "cpu" else "fused"
        assert calls == [want] * (axes[axis] - 1)
    assert torch.equal(results["cuda"], results["cpu"])
