"""Helpers the simulator, fault, obs, tune and elastic parity tests share.

Both packages compile the same program from the same local avals, the
reference's simulator and the port's run it on the same seeded numpy
input, and every output and every :class:`SimReport` field is compared.

R1 (jax 0.9's nested ``jit`` defeats the reference's mapper) moves
placements, and so timings: where the reference falls back to the host
(the int8 EF stages, the encoded int8 combine, ``map:masked_pack``) the
port places the stage.  :func:`with_port_placements` therefore runs the
reference on a copy of its compiled program whose stages (and plan)
carry the port's placements as reference :class:`Placement` /
:class:`HostFallback` objects.  Where the two mappers agree the copy
changes nothing; ``src/repro`` is never touched.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import core as J
from repro.cgra import device as jdev
from repro.cgra.simulate import SwitchSim as JSim
from repro_torch import core as T
from repro_torch.cgra.simulate import SwitchSim as TSim
from repro_torch.core.types import TensorSpec
from repro_torch.mesh import LocalMesh

AV = jax.ShapeDtypeStruct

# planted block peak (scale 2^-5): on f32 data whose 256-lane blocks peak
# at 127·2^k, XLA's reciprocal multiply and FMA contraction are exact
TOP = 127 * 2.0 ** -5


def _ref_device(d):
    return jdev.CGRADevice(**{f.name: getattr(d, f.name)
                              for f in dataclasses.fields(jdev.CGRADevice)
                              if f.init})


def ref_placement(pl):
    """The port's placement as the reference's type."""
    if pl is None:
        return None
    if not pl.fits:
        return jdev.HostFallback(pl.reason)
    kw = {f.name: getattr(pl, f.name)
          for f in dataclasses.fields(jdev.Placement) if f.init}
    kw["device"] = _ref_device(pl.device)
    return jdev.Placement(**kw)


def with_port_placements(jc, tc):
    """A copy of the reference program ``jc`` whose stages carry the
    port's placements (``tc``'s), plan included."""
    assert jc.stage_kinds() == tc.stage_kinds()
    stages = [dataclasses.replace(js, placement=ref_placement(ts.placement))
              for js, ts in zip(jc.stages, tc.stages)]
    plan = dataclasses.replace(jc.plan, stages=tuple(stages))
    return dataclasses.replace(jc, stages=stages, plan=plan)


def avals(shapes):
    """f32 avals of ``shapes`` in both packages: ``(reference, port)``."""
    return (tuple(AV(s, jnp.float32) for s in shapes),
            tuple(TensorSpec(s, torch.float32) for s in shapes))


def compile_pair(make_prog, shapes, sizes, backend="acis", outer=None,
                 **cfg):
    """``make_prog(acis)`` compiled rank-local in both packages:
    ``(port, reference)``."""
    ja, ta = avals(shapes)
    n = len(shapes)
    jc = J.make_engine(backend, outer_axis=outer, **cfg).compile(
        J.trace(make_prog(J), num_inputs=n, name="prog"), in_avals=ja,
        axis_size=sizes)
    tc = T.make_engine(backend, outer_axis=outer, **cfg).compile(
        T.trace(make_prog(T), num_inputs=n, name="prog"), in_avals=ta,
        axis_size=sizes)
    return tc, jc


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(np.ascontiguousarray(got).view(np.uint8),
                                  np.ascontiguousarray(want).view(np.uint8))


def report_fields(rep) -> dict:
    """Every field of a SimReport, by name (placements by their
    describe())."""
    return {
        "stages": [(s.kind, s.axis, s.schedule, s.t_sim, s.t_model, s.wave,
                    s.t_start, s.t_ser,
                    s.placement.describe() if s.placement is not None
                    else None) for s in rep.stages],
        "axes": dict(rep.axes), "t_end": rep.t_end,
        "t_program_model": rep.t_program_model,
        "rank_t_end": tuple(rep.rank_t_end),
        "t_sim": rep.t_sim, "t_model": rep.t_model,
    }


def assert_same_report(trep, jrep):
    """Exact equality: the port's clock is the reference's, operation for
    operation, in float64."""
    assert report_fields(trep) == report_fields(jrep)


def sim_pair(tc, jc, xs, *, faults=None, jfaults=None):
    """Run both simulators on the numpy inputs ``xs`` (port on CPU
    tensors); returns ``((port outs, report), (ref outs, report), port
    sim)``."""
    tsim = TSim(tc.topology, faults=faults)
    jsim = JSim(jc.topology, faults=jfaults)
    tout, trep = tsim.run(tc, *[torch.from_numpy(np.ascontiguousarray(x))
                                for x in xs])
    jout, jrep = jsim.run(with_port_placements(jc, tc), *xs)
    return (as_tuple(tout), trep), (as_tuple(jout), jrep), tsim


def executed(tc, sim, xs):
    """The port's compiled program executed on a CPU LocalMesh whose rank
    dims are the simulator's grid."""
    with LocalMesh(sim.sizes, device="cpu"):
        return tc(*[torch.from_numpy(np.ascontiguousarray(x)) for x in xs])


def assert_parity(tc, jc, xs, *, exec_bitwise=True, faults=None,
                  jfaults=None):
    """Port sim == reference sim (outputs bitwise, report exact) and ==
    the port's executed program (bitwise)."""
    (tout, trep), (jout, jrep), tsim = sim_pair(tc, jc, xs, faults=faults,
                                                jfaults=jfaults)
    assert len(tout) == len(jout)
    for t, j in zip(tout, jout):
        assert_bitwise(t, j)
    assert_same_report(trep, jrep)
    if exec_bitwise:
        for t, e in zip(tout, executed(tc, tsim, xs)):
            assert_bitwise(t, e)
    return tout, trep, jrep


def planted(rng, shape):
    """f32 ``shape`` whose every 256-lane block (per leading index) peaks
    at ``TOP``: lane 0, every 50th lane and the last lane hold it, the rest
    stay within ``TOP - 2^-5``."""
    x = np.clip(rng.standard_normal(shape) * TOP / 3,
                -(TOP - 2.0 ** -5), TOP - 2.0 ** -5).astype(np.float32)
    flat = x.reshape(shape[0], -1)
    flat[:, ::50] = TOP
    flat[:, -1] = TOP
    return x


def distinct_integers(rng, shape):
    """f32 ``shape`` holding, per leading index, a signed permutation of
    1..numel: every sum of them is exact (so any fold order gives the
    same bits) and no two magnitudes tie (so a top-k boundary is
    unique)."""
    lead, rest = shape[0], int(np.prod(shape[1:]))
    vals = np.stack([rng.permutation(rest) + 1.0 for _ in range(lead)])
    signs = np.where(rng.random((lead, rest)) < 0.5, -1.0, 1.0)
    return (vals * signs).astype(np.float32).reshape(shape)
