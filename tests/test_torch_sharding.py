"""The FSDP × TP layout of the port (``repro_torch.sharding``) against the
reference's (``repro.sharding``): parameter, batch, logits and cache specs
for all ten configs at full size on the test and production meshes (meta
tensors on the port's side, ``ShapeDtypeStruct`` s and an
``AbstractMesh`` on the reference's, so no 256-device host is needed),
the activation pins of ``shard_act``, and the layout's round trip."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as ref_configs
from repro.launch import cells as ref_cells
from repro.models import Model as RefModel
from repro.sharding import act as ref_act
from repro.sharding import rules as ref_rules
from repro_torch import configs, tree
from repro_torch.launch import cells
from repro_torch.mesh import LocalMesh, PartitionSpec as P
from repro_torch.models import Model
from repro_torch.sharding import act, rules

MESHES = {(2, 4): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}


def _meshes(sizes):
    names = MESHES[sizes]
    return (LocalMesh(dict(zip(names, sizes)), device="meta"),
            AbstractMesh(sizes, names))


def _norm(spec) -> tuple:
    """A spec's entries with a one-axis tuple as its axis (``P(("data",))``
    and ``P("data")`` are one layout; jax's spec normalises to the
    latter)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _ref_specs(t):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        t, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [(ref_rules._path_str(p), _norm(s)) for p, s in flat]


def _port_specs(t):
    return [(rules._path_str(p), _norm(s))
            for p, s in rules.leaves_with_paths(t)]


@pytest.mark.parametrize("sizes", list(MESHES))
@pytest.mark.parametrize("arch", configs.names())
def test_param_specs_match_the_reference(arch, sizes):
    mesh, amesh = _meshes(sizes)
    port_shapes = Model(configs.get(arch)).param_shapes()
    ref_shapes = RefModel(ref_configs.get(arch)).param_shapes()
    for par in ("fsdp_tp", "pure_dp"):
        got = _port_specs(rules.param_specs(port_shapes, mesh, par))
        want = _ref_specs(ref_rules.param_specs(ref_shapes, amesh, par))
        assert got == want, (arch, sizes, par)
    # batch and logits specs, and the DP axes
    for par in ("fsdp_tp", "pure_dp"):
        assert rules.dp_axes(mesh, par) == ref_rules.dp_axes(amesh, par)
        for extra in (1, 2):
            assert _norm(rules.batch_spec(mesh, extra, par)) == \
                _norm(ref_rules.batch_spec(amesh, extra, par))
    assert _norm(rules.logits_spec(mesh)) == \
        _norm(ref_rules.logits_spec(amesh))


@pytest.mark.parametrize("sizes", list(MESHES))
def test_cache_specs_match_the_reference(sizes):
    mesh, amesh = _meshes(sizes)
    for arch in configs.names():
        for shape, (b, s) in (("decode_32k", (128, 32768)),
                              ("long_500k", (1, 524288))):
            cfg = configs.get(arch)
            if shape == "long_500k" and not cfg.subquadratic:
                continue
            port = Model(cfg).init_cache(b, s, device="meta")
            ref = jax.eval_shape(
                lambda: RefModel(ref_configs.get(arch)).init_cache(b, s))
            got = _port_specs(cells.cache_specs(port, cfg, mesh, b))
            want = _ref_specs(ref_cells.cache_specs(
                ref, ref_configs.get(arch), amesh, b))
            assert got == want, (arch, shape, sizes)


class _Box:
    """Captures the spec the reference pins (its constraint is patched)."""

    def __init__(self):
        self.got = []

    def constraint(self, x, spec):
        self.got.append(_norm(spec))
        return x


# (shape, dims): the reference's call sites' forms, including 12 whisper
# heads against a 16-way model axis (the "tp" entry dropped), a batch of
# one (no "dp"), and a batch the DP ranks do not divide
PINS = [((32, 4096, 12, 64), ("dp", None, "tp", None)),
        ((32, 4096, 32, 128), ("dp", None, "tp", None)),
        ((1, 524288, 4096), ("dp", None, "tp")),
        ((24, 4096, 2048), ("dp", None, None)),
        ((60, 512, 2048), ("tp", "dp", None)),
        ((8, 60, 80, 2048), ("dp", None, None, None)),
        ((3, 16, 12), ("dp", None, "tp"))]


@pytest.mark.parametrize("sizes", list(MESHES))
def test_shard_act_specs_match_the_reference(sizes, monkeypatch):
    mesh, amesh = _meshes(sizes)
    box = _Box()
    monkeypatch.setattr(ref_act, "NamedSharding", lambda m, s: s)
    monkeypatch.setattr(ref_act.jax.lax, "with_sharding_constraint",
                        box.constraint)
    for par in ("fsdp_tp", "pure_dp"):
        for tp in (True, False):
            with ref_act.activation_sharding(amesh, tp=tp, parallelism=par):
                for shape, dims in PINS:
                    ref_act.shard_act(jax.ShapeDtypeStruct(shape, np.float32),
                                      *dims)
            with act.activation_sharding(mesh, tp=tp,
                                         parallelism=par) as ctx:
                for shape, dims in PINS:
                    x = torch.empty(shape, device="meta")
                    assert act.shard_act(x, *dims) is x
            got = [_norm(s) for _, _, s in ctx.records]
            assert got == box.got[-len(PINS):], (sizes, par, tp)
    if sizes == (16, 16):
        # 12 heads on 16: "tp" dropped, as the reference drops it
        assert box.got[0] == ("data", None, None, None)


def test_shard_act_is_a_no_op_outside_a_context():
    x = torch.ones(2, 3, 4)
    assert act.current() is None
    assert act.shard_act(x, "dp", None, "tp") is x
    with act.activation_sharding(LocalMesh({"data": 2, "model": 2},
                                           device="meta")) as ctx:
        act.shard_act(x, "dp", None, "tp")
    assert ctx.summary() == {"pins": 1, "tp_dropped": 0}
    assert act.current() is None


@pytest.mark.parametrize("axes", [{"data": 2, "model": 4},
                                  {"pod": 2, "data": 2, "model": 2}])
def test_shard_unshard_round_trip_bitwise(axes):
    mesh = LocalMesh(axes, device="cpu")
    cfg = configs.get_smoke("acis-100m")
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    specs = rules.param_specs(params, mesh)
    sharded = rules.shard_tree(params, specs, mesh)
    for x, s, y in zip(tree.tree_leaves(params), rules.spec_leaves(specs),
                       tree.tree_leaves(sharded)):
        assert tuple(y.shape) == mesh.rank_shape + rules.local_shape(
            x.shape, s, mesh)
        rules.constrain(y, mesh, s, tuple(x.shape))
    back = rules.unshard_tree(sharded, specs, mesh)
    for a, b in zip(tree.tree_leaves(params), tree.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError):
        rules.constrain(torch.zeros(3, 4), mesh, P())
