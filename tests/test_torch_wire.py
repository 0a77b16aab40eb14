"""repro_torch wire codecs against the JAX reference's.

Encode/decode, the checksum sidecar and blockwise int8 quantization on one
seeded numpy input.  Quantization is bitwise: both sides divide by the same
f32 scale and round half to even (``torch.round`` and ``jnp.round``), which
the exact .5 ties below pin down.  Inside a mesh every rank quantizes its
own payload, exactly as each reference rank does.
"""

import importlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.mesh import LocalMesh

# ``<pkg>.core.wire`` is shadowed by the traced ``wire`` op on the package
jwire = importlib.import_module("repro.core.wire")
twire = importlib.import_module("repro_torch.core.wire")


def assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _ties(rng, nblocks=3):
    """Blocks whose absmax is 127, so scale == 1 and x / scale == x: the
    .5 lanes are exact ties for the rounding."""
    x = rng.uniform(-126, 126, size=(nblocks, 256)).astype(np.float32)
    x[:, 0] = 127.0
    x[:, 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 125.5, -124.5]
    return x.reshape(-1)


@pytest.mark.parametrize("size", [1, 255, 256, 1000])
def test_quantize_matches_reference_bitwise(rng, size):
    x = (rng.standard_normal(size) * 3.0).astype(np.float32)
    wq, ws, wsize = jwire.quantize_int8(jnp.asarray(x))
    tq, ts, tsize = twire.quantize_int8(torch.from_numpy(x))
    assert tsize == wsize == size
    assert_bitwise(tq.numpy(), np.asarray(wq))
    assert_bitwise(ts.numpy(), np.asarray(ws))
    wy = jwire.dequantize_int8(wq, ws, wsize, (size,))
    ty = twire.dequantize_int8(tq, ts, tsize, (size,))
    assert_bitwise(ty.numpy(), np.asarray(wy))


def test_quantize_rounds_half_to_even(rng):
    x = _ties(rng)
    wq, _, _ = jwire.quantize_int8(jnp.asarray(x))
    tq, ts, _ = twire.quantize_int8(torch.from_numpy(x))
    assert float(ts[0]) == 1.0
    assert tq.numpy()[0, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -124]
    assert_bitwise(tq.numpy(), np.asarray(wq))


def test_quantize_per_rank_inside_a_mesh(rng):
    """Each rank's payload is quantized on its own (rank dims in front)."""
    x = (rng.standard_normal((8, 300)) * 2.0).astype(np.float32)
    with LocalMesh({"data": 8}, device="cpu"):
        tq, ts, size = twire.quantize_int8(torch.from_numpy(x))
        ty = twire.dequantize_int8(tq, ts, size, (300,))
    assert tuple(tq.shape) == (8, 2, 256) and size == 300
    for r in range(8):
        wq, ws, _ = jwire.quantize_int8(jnp.asarray(x[r]))
        assert_bitwise(tq[r].numpy(), np.asarray(wq))
        assert_bitwise(ts[r].numpy(), np.asarray(ws))
    np.testing.assert_allclose(ty.numpy(), x, atol=3.5 * np.abs(x).max()
                               / 127)


def test_int8_encoded_combine_matches_reference(rng):
    a = (rng.standard_normal(700) * 2.0).astype(np.float32)
    b = (rng.standard_normal(700) * 5.0).astype(np.float32)
    ja = jwire.quantize_int8(jnp.asarray(a))[:2]
    jb = jwire.quantize_int8(jnp.asarray(b))[:2]
    ta = twire.quantize_int8(torch.from_numpy(a))[:2]
    tb = twire.quantize_int8(torch.from_numpy(b))[:2]
    wq, ws = jwire._int8_combine(ja, jb)
    tq, ts = twire.int8_codec().combine_encoded(ta, tb)
    # the reference's XLA may contract q*s + q*s into one FMA: the f32
    # sums, hence scales, agree to an ulp, and a lane can requantize one
    # int8 step away
    np.testing.assert_allclose(ts.numpy(), np.asarray(ws), rtol=2e-7)
    assert np.abs(tq.numpy().astype(int)
                  - np.asarray(wq).astype(int)).max() <= 1


def test_int8_codec_round_trip_keeps_shape_and_dtype(rng):
    x = rng.standard_normal((5, 60)).astype(np.float32)
    jc, tc = jwire.int8_codec(), twire.int8_codec()
    want = np.asarray(jc.decode(jc.encode(jnp.asarray(x))))
    got = tc.decode(tc.encode(torch.from_numpy(x)))
    assert tuple(got.shape) == (5, 60) and got.dtype == torch.float32
    assert_bitwise(got.numpy(), want)
    assert tc.wire_ratio == jc.wire_ratio
    assert tc.name == jc.name


def test_int8_codec_kernels_carry_the_fused_hop(rng):
    """Under ``use_kernels`` the codec's combine carries the one-launch
    ring step ``fused_hop`` (the ``quant_hop`` kernel), which the encoded
    ring takes on CUDA leaves; without it there is no such form.  On CPU
    tensors the hop is its plain version: the combine of the neighbour's
    partial sum and the local chunk."""
    from repro_torch.kernels import quant_combine as tqc

    assert not hasattr(twire.int8_codec().combine_encoded, "fused_hop")
    comb = twire.int8_codec(use_kernels=True).combine_encoded
    assert callable(comb.fused_hop)
    q = torch.from_numpy(rng.integers(-127, 128, (8, 8, 3, 256)).astype(
        np.int8))
    s = torch.from_numpy(rng.uniform(0.1, 2, (8, 8, 3)).astype(np.float32))
    buf = (q[:, 1].clone(), s[:, 1].clone())
    got = comb.fused_hop(buf, (q, s), 2, dim=0, rank_ndim=1)
    want = tqc.hop_plain(*buf, q, s, 2, dim=0, rank_ndim=1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # rank 3 combines rank 2's partial sum with its chunk (3 - 2 - 2) % 8
    one = comb((buf[0][2], buf[1][2]), (q[3, 7], s[3, 7]))
    assert torch.equal(got[0][3], one[0]) and torch.equal(got[1][3], one[1])


@pytest.mark.parametrize("name", ["bf16", "fp8"])
def test_cast_codecs_match_reference(rng, name):
    """In-range values: both round to nearest even in the wire dtype."""
    x = (rng.standard_normal(513) * 4.0).astype(np.float32)
    jc, tc = jwire.CODECS[name], twire.CODECS[name]
    wenc = np.asarray(jc.encode(jnp.asarray(x)))
    tenc = tc.encode(torch.from_numpy(x))
    npdt = {"bf16": ml_dtypes.bfloat16, "fp8": ml_dtypes.float8_e4m3fn}[name]
    assert_bitwise(tenc.view(torch.uint8).numpy().view(npdt), wenc)
    assert_bitwise(tc.decode(tenc).numpy(),
                   np.asarray(jc.decode(jnp.asarray(wenc))))
    assert tc.wire_ratio == jc.wire_ratio


def test_checksum_matches_reference_and_detects_corruption(rng):
    x = rng.standard_normal(257).astype(np.float32)
    _, (wt, ws) = jwire.checksum_tag(jnp.asarray(x))
    t, tag = twire.checksum_tag(torch.from_numpy(x))
    assert int(tag[0]) == int(wt) and int(tag[1]) == int(ws)
    assert bool(twire.checksum_verify(torch.from_numpy(x), tag))
    bad = x.copy()
    bad[17] += 1.0
    assert not bool(twire.checksum_verify(torch.from_numpy(bad), tag))


def test_resolve_codec():
    assert twire.resolve_codec("identity") is twire.IDENTITY
    assert twire.resolve_codec("bf16") is twire.BF16
    a, b = twire.resolve_codec("int8"), twire.resolve_codec("int8")
    assert a is not b and a.name == "int8_b256"
    with pytest.raises(ValueError, match="unknown wire codec"):
        twire.resolve_codec("zstd")
