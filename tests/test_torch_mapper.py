"""repro_torch's CGRA mapper and PlaceCGRA pass against the JAX reference.

The reference traces each stage body to a jaxpr under ``vmap`` axis
frames; the port traces it with ``make_fx`` inside a ``LocalMesh`` on the
``meta`` device and names every ATen op by the device vocabulary.  Where
the reference places a stage, the port's placement must be the same —
kind, ALU ops (by name, in level order), depth, initiation interval and
the PEs it occupies — and so must ``program_time()``.  The steering count
``n_route`` may differ only where ATen spells data movement otherwise than
a jaxpr; each such stage is named with its cause (:data:`ROUTE_SPELLED`).

R1: on jax 0.9 the reference's jnp helpers (``clip``, ``where``,
``round``) trace as nested ``jit`` primitives its mapper does not inline,
so its int8 pipelines and the masked pack fall back to the host.  The
port is held to what the reference's docstrings intend instead — the int8
EF compressor is placed, the encoded combine is placed and priced by its
ALU count, and a masked sync prices within 5% of a plain one — and each
case also shows the reference's fallback.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.cgra.device import HostFallback as JHostFallback
from repro.core import lookaside as jla
from repro_torch import core as T
from repro_torch.cgra import mapper
from repro_torch.cgra.device import (ALU_PRIMS, CGRADevice, HostFallback,
                                     PAPER_CGRA, Placement, placement_rate,
                                     route_through)
from repro_torch.core import lookaside as tla
from repro_torch.core import netmodel
from repro_torch.core.compiler import (Emit, FuseHops, Legalize,
                                       LowerTopology, PlaceCGRA,
                                       SelectSchedule, compile_rank_local)
from repro_torch.core.types import TensorSpec

AV = jax.ShapeDtypeStruct
HIER = {"data": 4, "pod": 2}

# stages whose steering count differs, and why: the reference's
# pad_to_multiple reads the pad through the vmap frame and spells the
# identity fill as reshape + broadcast_in_dim + pad/concatenate (4 ops);
# the port's is one full and one cat
ROUTE_SPELLED = {"map:hier_pad"}


def _avals(shapes, dtypes=None):
    dtypes = dtypes or [None] * len(shapes)
    j = tuple(AV(s, d[0] if d else jnp.float32)
              for s, d in zip(shapes, dtypes))
    t = tuple(TensorSpec(s, d[1] if d else torch.float32)
              for s, d in zip(shapes, dtypes))
    return j, t


def _pair(make_prog, shapes, *, backend="acis", sizes=8, outer=None,
          dtypes=None, **cfg):
    """One program (built per package by ``make_prog(acis)``) compiled
    rank-local in both packages from the same local avals."""
    ja, ta = _avals(shapes, dtypes)
    jc = J.make_engine(backend, outer_axis=outer, **cfg).compile(
        make_prog(J), in_avals=ja, axis_size=sizes)
    tc = T.make_engine(backend, outer_axis=outer, **cfg).compile(
        make_prog(T), in_avals=ta, axis_size=sizes)
    return tc, jc


def _label(st) -> str:
    if st.kind == "map":
        name = next((nd.op.name for nd in st.ir.nodes if nd.op.name), "")
        return f"map:{name}"
    return st.kind


def placement_view(pl) -> tuple:
    if isinstance(pl, (HostFallback, JHostFallback)):
        return ("fallback",)
    return ("placed", pl.n_ops, pl.depth, pl.ii, tuple(pl.pes),
            tuple(pl.ops))


def assert_same_placements(tc, jc):
    assert tc.stage_kinds() == jc.stage_kinds()
    for ts, js in zip(tc.stages, jc.stages):
        assert placement_view(ts.placement) == \
            placement_view(js.placement), _label(js)
        if js.placement.fits and _label(js) not in ROUTE_SPELLED:
            assert ts.placement.n_route == js.placement.n_route, _label(js)
    assert tc.program_time() == pytest.approx(jc.program_time(), rel=1e-9)


# ---------------------------------------------------------------------------
# parity: the gradient syncs and the fused programs
# ---------------------------------------------------------------------------

def _sync(n_leaves, masked=False):
    """The engine's gradient-sync program, built per package: per leaf a
    mean of ``reduce(axis="auto")``, or the bounded-staleness
    ``masked_reduce`` with one alive flag."""
    def make(a):
        def mean(y):
            return y / 8

        def sync(*args):
            if masked:
                alive, args = args[-1], args[:-1]
                return tuple(a.masked_reduce(g, alive, a.ADD, axis="auto")[0]
                             for g in args)
            return tuple(a.map(mean, a.reduce(g, axis="auto"), name="mean",
                               elementwise=True) for g in args)
        return a.trace(sync, num_inputs=n_leaves + int(masked),
                       name="sync")
    return make


@pytest.mark.parametrize("backend", ["acis", "acis_hierarchical"])
@pytest.mark.parametrize("shapes", [[(7,), (24,)], [(37, 40), (4096,)]])
def test_sync_placements_match_reference(backend, shapes):
    hier = backend == "acis_hierarchical"
    tc, jc = _pair(_sync(len(shapes)), shapes, backend=backend,
                   sizes=HIER if hier else 8, outer="pod" if hier else None)
    assert_same_placements(tc, jc)
    assert all(st.placement is not None for st in tc.stages)
    if hier:
        labels = [_label(st) for st in tc.stages]
        assert "map:hier_pad" in labels and "map:hier_unpad" in labels


def test_full_width_hierarchical_sync_prices_like_the_reference():
    """The acis-100m gradients at full width on pod 2 × data 4: every
    stage's placement and the program's cost-model time."""
    from repro.configs.acis_100m import CONFIG as JCONFIG
    from repro.models.model import Model
    from repro_torch.configs.acis_100m import CONFIG, grad_leaf_specs
    from repro_torch.mesh import LocalMesh

    jeng = J.make_engine("acis_hierarchical", outer_axis="pod")
    jeng.init_arenas(Model(JCONFIG).param_shapes(), axis_sizes=HIER)
    teng = T.make_engine("acis_hierarchical", outer_axis="pod")
    grads = {k: torch.empty((2, 4) + s, dtype=dt, device="meta")
             for k, s, dt in grad_leaf_specs(CONFIG)}
    teng.init_arenas(grads, mesh=LocalMesh({"pod": 2, "data": 4},
                                           device="meta"))
    assert_same_placements(teng.last_sync_program(),
                           jeng.last_sync_program())


def _square(a):
    return jnp.square if a is J else torch.square


FUSED = {
    "fig5": (lambda a: lambda v: a.all_gather(a.scan(a.all_gather(v))),
             [(16,)], None),
    "fig5_2d": (lambda a: lambda v: a.all_gather(a.scan(a.all_gather(v))),
                [(16, 4)], None),
    "nas_is": (lambda a: lambda h, k: (a.reduce(h), a.all_to_all(k)),
               [(16,), (64,)], [None, (jnp.int32, torch.int32)]),
    "map_rs": (lambda a: lambda v: a.reduce_scatter(
        a.map(_square(a), v, name="square")), [(64,)], None),
    "ag_map": (lambda a: lambda v: a.map(
        _square(a), a.all_gather(v), name="square"), [(64,)], None),
    "map_ar": (lambda a: lambda v: a.reduce(
        a.map(_square(a), v, name="sq")), [(64,)], None),
    "tanh_map_ar": (lambda a: lambda v: a.reduce(a.map(
        lambda x: (jnp.tanh(x) if a is J else torch.tanh(x)) * 3 + 1, v,
        name="body")), [(64,)], None),
    "max_ar": (lambda a: lambda v: a.reduce(v, a.MAX), [(64,)], None),
    "rs_ag": (lambda a: lambda v: a.all_gather(a.reduce_scatter(v)),
              [(64,)], None),
}


@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_program_placements_match_reference(name):
    make, shapes, dtypes = FUSED[name]
    tc, jc = _pair(make, shapes, dtypes=dtypes)
    assert_same_placements(tc, jc)


@pytest.mark.parametrize("name,make,shapes,jprim,tprim", [
    ("gcn", lambda a: lambda ab, xb: a.map(
        lambda p, q: (jla if a is J else tla).gcn_aggregate(p, q, "data"),
        ab, xb, name="gcn_aggregate"), [(8, 8, 8), (8, 5)], "scan",
     "aten.index"),
    ("mm", lambda a: lambda x, y: a.reduce(a.map(
        lambda p, q: p @ q, x, y, name="mm")), [(8, 8), (8, 8)],
     "dot_general", "aten.bmm"),
])
def test_lookaside_bodies_fall_back_in_both(name, make, shapes, jprim,
                                            tprim):
    """Bodies the switch cannot run — the GCN ring rotation (a loop of
    gathers), a matmul (no MAC array) — fall back in both packages, each
    naming its own spelling of the op; the detour prices alike."""
    tc, jc = _pair(make, shapes)
    (tfb,) = [st.placement for st in tc.stages
              if isinstance(st.placement, HostFallback)]
    (jfb,) = [st.placement for st in jc.stages
              if isinstance(st.placement, JHostFallback)]
    assert repr(tprim) in tfb.reason and repr(jprim) in jfb.reason
    assert tc.program_time() == pytest.approx(jc.program_time(), rel=1e-9)


# ---------------------------------------------------------------------------
# R1: the cases the reference falls back on, held to their intent
# ---------------------------------------------------------------------------

def test_int8_ef_compressor_fits():
    """The shared-scale int8 compressor's rank-local pipeline places: its
    absmax tree over a 256-lane block is 8 levels deep and its ALU ops fit
    the 16 PEs.  The reference falls back on ``jit`` (R1)."""
    tc, jc = _pair(lambda a: lambda x: a.ef_reduce(x, axis="data")[0],
                   [(1024,)], backend="acis_compressed")
    (st,) = tc.stages
    pl = st.placement
    assert isinstance(pl, Placement) and pl.fits
    assert pl.ops == ("abs", "reduce_max", "gt", "div", "select_n", "div",
                      "round", "clamp", "convert_element_type",
                      "convert_element_type", "mul")
    assert pl.ii == 1 and pl.depth == 17 and pl.pes_used == 6
    (jst,) = jc.stages
    assert isinstance(jst.placement, JHostFallback)
    assert "'jit'" in jst.placement.reason
    assert tc.program_time() < jc.program_time()     # no host detour


def test_encoded_codec_combine_costs_throughput():
    """The int8 encoded-domain combine places, and the placement says
    what compression costs in the switch: 14 ALU ops (dequantize both,
    add, absmax, requantize) on 7 PEs and an 18-level pipe against the
    plain add's one op.  Its II exceeds 1 once the grid has fewer PEs
    than ops: on the paper's 16-PE grid the 14 ops still issue in one
    cycle (II 1), on a 3 × 4 grid they take two (II 2, half the line
    rate).  The reference falls back on ``jit`` (R1); with ``jit``
    inlined it counts 19 ops — a dead ``max``, ``clip`` as two ops and
    three conversions of literals — hence its II 2 on 16 PEs."""
    def make(a):
        return lambda x: a.reduce(x, axis="auto")

    tc, jc = _pair(make, [(1 << 14,)],
                   backend="acis_hierarchical_compressed", sizes=HIER,
                   outer="pod")
    outer = next(s for s in tc.stages if s.kind == "allreduce")
    pl = outer.placement
    assert pl.fits and pl.ops == (
        "convert_element_type", "convert_element_type", "mul", "mul",
        "add", "abs", "reduce_max", "gt", "div", "select_n", "div",
        "round", "clamp", "convert_element_type")
    rs = next(s for s in tc.stages if s.kind == "reduce_scatter")
    assert pl.pes_used > rs.placement.pes_used
    assert pl.depth > rs.placement.depth
    assert pl.ii == 1
    small = CGRADevice(rows=3, cols=4)
    tc2 = T.make_engine("acis_hierarchical_compressed", outer_axis="pod",
                        cgra_device=small).compile(
        make(T), in_avals=(TensorSpec((1 << 14,), torch.float32),),
        axis_size=HIER)
    pl2 = next(s for s in tc2.stages if s.kind == "allreduce").placement
    assert pl2.fits and pl2.ii == 2
    assert pl2.bytes_per_s == small.line_rate / 2 < small.line_rate
    jouter = next(s for s in jc.stages if s.kind == "allreduce")
    assert isinstance(jouter.placement, JHostFallback)
    assert "'jit'" in jouter.placement.reason


@pytest.mark.parametrize("backend", ["acis", "acis_hierarchical"])
def test_masked_sync_overhead_gate(backend):
    """At zero faults the masked sync prices within 5% of the plain one —
    the count lane plus a hidden epilogue, not a second launch — and its
    pack and renorm epilogues stay on the switch.  The reference's masked
    pack falls back on ``jit`` (R1)."""
    hier = backend == "acis_hierarchical"
    kw = dict(backend=backend, sizes=HIER if hier else 8,
              outer="pod" if hier else None)
    shapes = [(4096,), (128,)]
    tp, jp = _pair(_sync(2), shapes, **kw)
    tm, jm = _pair(_sync(2, masked=True), shapes + [()], **kw)
    assert tm.program_time() <= 1.05 * tp.program_time()
    assert not [st for st in tm.stages
                if isinstance(st.placement, HostFallback)]
    pack = next(st.placement for st in tm.stages
                if _label(st) == "map:bucket_pack")
    assert pack.ops == ("ne", "select_n", "select_n")
    jpack = next(st.placement for st in jm.stages
                 if _label(st) == "map:bucket_pack")
    assert isinstance(jpack, JHostFallback) and "'jit'" in jpack.reason
    assert jm.program_time() > 1.05 * jp.program_time()


# ---------------------------------------------------------------------------
# the rest of tests/test_cgra_mapper.py
# ---------------------------------------------------------------------------

def _compile(fn, avals, backend="acis", sizes=8, outer=None, **cfg):
    return T.make_engine(backend, outer_axis=outer, **cfg).compile(
        fn, in_avals=tuple(TensorSpec(s, torch.float32) for s in avals),
        axis_size=sizes)


def test_map_allreduce_stage_gets_placed():
    c = _compile(lambda x: T.reduce(T.map(torch.square, x, name="sq")),
                 [(64,)])
    (st,) = c.stages
    assert st.kind == "map+allreduce"
    pl = st.placement
    assert isinstance(pl, Placement) and pl.fits
    assert pl.ops == ("square", "add")
    assert 0 < pl.pes_used <= PAPER_CGRA.n_pes and pl.bytes_per_s > 0


def test_movement_stage_is_route_through():
    c = _compile(lambda x: T.all_gather(x), [(16,)])
    (st,) = c.stages
    assert st.placement.fits and st.placement.pes_used == 0


def test_hier_pad_bookkeeping_maps_route_through():
    c = _compile(lambda x: T.reduce(x, axis="auto"), [(128,)],
                 backend="acis_hierarchical", sizes=HIER, outer="pod")
    assert c.stage_kinds() == ["map", "reduce_scatter", "allreduce",
                               "allgather", "map"]
    pads = [s.placement for s in c.stages if s.kind == "map"]
    assert all(p.fits and p.n_ops == 0 for p in pads)


def test_unsupported_map_body_falls_back_to_host():
    c = _compile(lambda a, b: T.reduce(T.map(lambda x, y: x @ y, a, b,
                                             name="mm")), [(8, 8), (8, 8)])
    st = next(s for s in c.stages if s.kind == "map")
    assert isinstance(st.placement, HostFallback)
    assert "aten.bmm" in st.placement.reason


def test_collective_inside_map_body_falls_back():
    """A MAP body that itself communicates (a roll along a rank dim) is
    endpoint code, not a dataflow graph one switch can run."""
    c = _compile(lambda x: T.map(
        lambda v: tla.distributed_prefix_sum(v, "data"), x, name="dps"),
        [(16,)])
    (st,) = c.stages
    assert isinstance(st.placement, HostFallback)
    assert "aten.roll" in st.placement.reason


def test_topk_compressor_falls_back():
    c = _compile(lambda x: T.ef_reduce(x, axis="data",
                                       compressor="topk")[0], [(256,)],
                 backend="acis_compressed")
    (st,) = c.stages
    assert isinstance(st.placement, HostFallback)
    assert "top-k sparsifier" in st.placement.reason
    assert "aten.topk" in st.placement.reason


def test_tiny_device_forces_fallback():
    tiny = CGRADevice(rows=1, cols=1, ops_per_pe=1)
    pipeline = (Legalize(), LowerTopology(), FuseHops(), SelectSchedule(),
                PlaceCGRA(device=tiny), Emit())
    c = compile_rank_local(
        lambda x: T.reduce(T.map(lambda v: torch.tanh(v) * 3 + 1, x,
                                 name="body")),
        "data", axis_size=8, in_avals=(TensorSpec((64,), torch.float32),),
        pipeline=pipeline)
    (st,) = c.stages
    assert isinstance(st.placement, HostFallback)
    assert "ALU slots" in st.placement.reason


@pytest.mark.parametrize("backend", ["acis", "acis_compressed",
                                     "acis_hierarchical",
                                     "acis_hierarchical_compressed"])
def test_every_stage_carries_placement_or_fallback(backend):
    """No stage leaves the pipeline unmapped on any backend."""
    hier = "hierarchical" in backend
    eng = T.make_engine(backend, inner_axis="data",
                        outer_axis="pod" if hier else None)

    def sync(g, r):
        t = T.map(lambda g_, r_: g_ + r_, g, r, name="ef_target")
        if "compressed" in backend:
            red, dlv = T.ef_reduce(t, axis="auto")
            out = T.map(lambda y: y / 8.0, red, name="mean")
            res = T.map(lambda t_, d: t_ - d, t, dlv, name="ef_residual")
            return out, res
        red = T.reduce(t, axis="auto")
        return T.map(lambda y: y / 8.0, red, name="mean"), t

    c = eng.compile(sync, in_avals=(TensorSpec((64,), torch.float32),) * 2,
                    axis_size=HIER if hier else {"data": 8})
    assert len(c.stages) >= 1
    for st in c.stages:
        assert isinstance(st.placement, (Placement, HostFallback)), st.kind
        assert st.ir is not None


def test_data_dependent_and_loop_bodies_fall_back_not_placed():
    """A body make_fx cannot trace (a branch on data) and a higher-order
    loop or conditional (no sequential controller) fall back; neither is
    placed at line rate."""
    def branchy(v):
        return v * 2 if bool((v > 0).all()) else v

    c = _compile(lambda x: T.map(branchy, x, name="branchy"), [(8, 4)])
    (st,) = c.stages
    assert isinstance(st.placement, HostFallback)
    assert "not a rank-local dataflow graph" in st.placement.reason

    def cond_body(v):
        return torch.cond(v.sum() > 0, lambda t: t + 1, lambda t: t - 1,
                          (v,))

    c = _compile(lambda x: T.map(cond_body, x, name="cond"), [(8, 4)])
    (st,) = c.stages
    assert isinstance(st.placement, HostFallback)


def test_device_supported_set_is_honored():
    no_tanh = CGRADevice(supported=ALU_PRIMS - {"tanh"})
    c = _compile(lambda x: T.reduce(T.map(torch.tanh, x, name="act")),
                 [(64,)], cgra_device=no_tanh)
    (st,) = c.stages
    assert isinstance(st.placement, HostFallback)
    assert "tanh" in st.placement.reason
    c2 = _compile(lambda x: T.reduce(T.map(torch.tanh, x, name="act")),
                  [(64,)])
    assert c2.stages[0].placement.fits


def test_engine_config_cgra_device_override():
    tiny = CGRADevice(rows=1, cols=1, ops_per_pe=1)
    eng = T.make_engine("acis", cgra_device=tiny)
    assert tiny in eng.config.cache_key()
    c = eng.compile(lambda x: T.reduce(T.map(
        lambda v: torch.tanh(v) * 3 + 1, x, name="body")),
        in_avals=(TensorSpec((64,), torch.float32),), axis_size=8)
    (st,) = c.stages
    assert isinstance(st.placement, HostFallback)


def test_placecgra_annotates_desc_with_model_time():
    c = _compile(lambda x: T.reduce(x), [(1 << 16,)])
    (st,) = c.stages
    assert "model" in st.desc and "us" in st.desc


def test_explain_lists_placements():
    tc, jc = _pair(lambda a: lambda x: a.reduce(a.map(
        _square(a), x, name="sq")), [(64,)])
    txt = tc.explain()
    assert "map+allreduce" in txt and "PEs" in txt and "placement" in txt
    assert txt.splitlines()[1:-1] == jc.explain().splitlines()[1:-1]


def test_explain_with_a_recording_prices_every_stage():
    """explain(trace=...) and program_time no longer wait for anything:
    the executor's instrumented spans price against the model."""
    from repro_torch.mesh import LocalMesh

    c = _compile(lambda x: T.reduce(T.map(torch.square, x, name="sq")),
                 [(64,)])
    spans: list = []
    with LocalMesh({"data": 8}, device="cpu"):
        c(torch.ones(8, 64), instrument=spans)
    txt = c.explain(trace=spans)
    assert "meas_us" in txt and "1/1 stages priced" in txt
    assert c.program_time() > 0


def test_stage_bodies_trace_plain_versions_on_meta():
    """Bodies trace on meta tensors carrying the rank dims, and a kernel
    codec's combine is never what gets traced (the plain one is)."""
    gm = mapper.trace_body(lambda a, b: a + b,
                           (TensorSpec((5,), torch.float32),) * 2,
                           {"data": 4, "pod": 2})
    ph = [n for n in gm.graph.nodes if n.op == "placeholder"]
    assert [tuple(n.meta["val"].shape) for n in ph] == [(4, 2, 5)] * 2
    assert all(n.meta["val"].device.type == "meta" for n in ph)
    g = mapper.lower_graph(gm)
    assert g.ops == (("add", 0),) and g.depth == 1


# ---------------------------------------------------------------------------
# the device model and netmodel views the placements feed
# ---------------------------------------------------------------------------

def test_paper_device_matches_table_ii_rate():
    assert PAPER_CGRA.line_rate == 250e6 * 64
    p = netmodel.PAPER
    assert p.accel_clock == PAPER_CGRA.clock_hz
    assert p.accel_width == PAPER_CGRA.lane_bytes
    assert netmodel.accel_rate(p) == PAPER_CGRA.line_rate


def test_placement_rate_drops_with_ii():
    pl = Placement(device=PAPER_CGRA, n_ops=20, n_route=0, depth=3, ii=2)
    assert pl.bytes_per_s == PAPER_CGRA.line_rate / 2
    assert placement_rate(pl) == pl.bytes_per_s
    assert placement_rate(None) == PAPER_CGRA.line_rate
    with pytest.raises(ValueError, match="host-fallback"):
        placement_rate(HostFallback("because"))
    rt = route_through(PAPER_CGRA, 3)
    assert rt.fits and rt.pes_used == 0
    assert rt.bytes_per_s == PAPER_CGRA.line_rate


def test_stage_time_fallback_charges_pcie_and_mpi():
    m = 1 << 20
    fits = Placement(device=PAPER_CGRA, n_ops=2, n_route=0, depth=2, ii=1)
    with pytest.raises(ValueError, match="no constant-rate default"):
        netmodel.stage_time("map", 8, m, netmodel.PAPER)
    t_fit = netmodel.stage_time("map+allreduce", 8, m, netmodel.PAPER,
                                placement=fits)
    t_fb = netmodel.stage_time("map+allreduce", 8, m, netmodel.PAPER,
                               placement=HostFallback("too big"))
    assert t_fb > t_fit >= 0
    assert t_fb >= netmodel.host_fallback_time(m, netmodel.PAPER)
    slow = Placement(device=PAPER_CGRA, n_ops=40, n_route=0, depth=4, ii=4)
    assert netmodel.ring_allreduce_time(8, 1 << 22, placement=slow) > \
        netmodel.ring_allreduce_time(8, 1 << 22, placement=fits)
    np.testing.assert_allclose(
        netmodel.host_fallback_time(m, netmodel.PAPER),
        2 * netmodel.PAPER.pcie + netmodel.PAPER.mpi_overhead
        + m / netmodel.PAPER.host_bw)
