"""GPipe over "pipe" (``repro_torch.train.pipeline``) against the
sequential stages and the reference's ``run_pipeline`` (the same ``s, m,
mb, dim`` as ``test_train_substrate.py``'s), with and without the int8
wire codec on the handoff, and with fewer microbatches than stages."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.pipeline import run_pipeline as ref_run_pipeline
from repro_torch.core.wire import int8_codec
from repro_torch.mesh import LocalMesh
from repro_torch.train.pipeline import run_pipeline

# the package's ``wire`` attribute is the traced wire op, not the module
ref_wire = importlib.import_module("repro.core.wire")
S, MB, DIM = 4, 3, 8


def _inputs(m, seed=0):
    rng = np.random.default_rng(seed)
    ws = (rng.standard_normal((S, DIM, DIM)) * 0.5).astype(np.float32)
    x = rng.standard_normal((m, MB, DIM)).astype(np.float32)
    return ws, x


def _stage(wslice, xin):       # wslice: [S, 1, dim, dim]; xin [S, mb, dim]
    return torch.tanh(xin @ wslice[:, 0])


def _ref_stage(wslice, xin):   # the reference's: [1, dim, dim] local
    return jnp.tanh(xin @ wslice[0])


def _sequential(ws, x, codec=None):
    y = x
    for i in range(S):
        y = np.tanh(y @ ws[i])
        if codec is not None and i < S - 1:
            y = codec(y)
    return y


def _mesh():
    return LocalMesh({"pipe": S}, device="cpu")


@pytest.mark.parametrize("m", [6, 2])
def test_pipeline_matches_sequential(m):
    """M = 6 microbatches (11 ticks), and M = 2 < S (5 ticks)."""
    ws, x = _inputs(m)
    got = run_pipeline(_mesh(), _stage, torch.from_numpy(ws),
                       torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _sequential(ws, x), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pipe_mesh(devices):
    return jax.make_mesh((S,), ("pipe",),
                         axis_types=(jax.sharding.AxisType.Auto,),
                         devices=devices[:S])


def test_pipeline_matches_the_reference(pipe_mesh):
    ws, x = _inputs(6)
    got = run_pipeline(_mesh(), _stage, torch.from_numpy(ws),
                       torch.from_numpy(x)).numpy()
    want = np.asarray(ref_run_pipeline(pipe_mesh, _ref_stage,
                                       jnp.asarray(ws), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _int8_round_trip(y):
    """The codec's arithmetic on one rank's [mb, dim] payload (one
    256-lane block): y quantized to absmax/127 steps and back."""
    flat = y.reshape(y.shape[0], -1)
    step = np.abs(flat).max(-1, keepdims=True) / 127.0
    step = np.where(step > 0, step, 1.0)
    return (np.clip(np.round(flat / step), -127, 127) * step).reshape(
        y.shape).astype(np.float32), step


def test_pipeline_int8_codec_matches_the_reference(pipe_mesh):
    """The int8 wire codec on every handoff: the port against the
    reference's pipeline with its codec, and both within the bound the
    codec's absmax step gives against the exact stages: each handoff
    moves a value by at most half a step, which the next stages carry
    through tanh (1-Lipschitz) and ``@ W`` (at most ‖W‖_∞ per row)."""
    m = 6
    ws, x = _inputs(m)
    got = run_pipeline(_mesh(), _stage, torch.from_numpy(ws),
                       torch.from_numpy(x), int8_codec()).numpy()
    want = np.asarray(ref_run_pipeline(pipe_mesh, _ref_stage,
                                       jnp.asarray(ws), jnp.asarray(x),
                                       ref_wire.int8_codec()))
    # the two codecs round the same steps; a tie broken apart by the
    # last bit of a product is one step on one lane at most
    exact = _sequential(ws, x)
    norms = np.abs(ws).sum(1).max(-1)            # ‖W_s‖_∞ (row sums)
    bound = np.zeros(())
    y = x
    for i in range(S):
        y = np.tanh(y @ ws[i])
        if i < S - 1:
            _, step = _int8_round_trip(y.reshape(-1, MB * DIM))
            bound = (bound + step.max() / 2) * norms[i + 1]
    assert np.abs(got - exact).max() <= bound + 1e-5
    assert np.abs(want - exact).max() <= bound + 1e-5
    np.testing.assert_allclose(got, want, atol=2 * bound)
    # the codec did act: the int8 run is not the identity run
    assert np.abs(got - exact).max() > 1e-5
