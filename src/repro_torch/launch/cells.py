"""Cell building: the (train | prefill | decode) program of one
architecture × shape × mesh, run on the meta device and counted.

The port of :mod:`repro.launch.cells`.  The reference lowers and
compiles each cell with ``ShapeDtypeStruct`` inputs; here the program
*runs* on ``meta`` tensors — shapes and dtypes, no data, no allocation —
under three counters (:class:`Counters`): matmul and attention FLOPs
(``FlopCounterMode``), an operand-plus-result byte count and the peak of
live bytes (a ``TorchDispatchMode``), and the native collective log.
That is the shape-only dry run.

  * train: :func:`repro_torch.train.step.build_train_step_gspmd` on the
    mesh (every rank a slice of each meta tensor), its params and
    optimizer state placed by ``param_specs`` / ``_opt_specs``; the
    counts are the whole mesh's, divided by its ranks;
  * prefill / decode: one rank's program (every rank runs the same):
    its params as stored, each gathered to its compute layout (the split
    projections of ``tp_plan`` and expert-parallel expert banks a
    ``model`` slice, everything else whole;
    the stacked layers one period at a time, each FSDP gather logged as
    an all-gather), its batch slice and its cache slice under
    :func:`cache_specs`, the forward under a hook that logs each
    row-parallel all-reduce.  No kernel runs on meta tensors: the
    models' plain versions do.

Eager execution counts every layer and microbatch, so a whole cell's
count is exact; the linear probes (:func:`build_probe`,
:func:`compose_probe_costs`) exist so that a 60-layer, 16-microbatch
cell costs seconds, not minutes, of Python dispatch.
"""

from __future__ import annotations

import dataclasses
import math
import time
import weakref
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs, tree
from repro_torch.launch.shapes import SHAPES, ShapeCell, applicable
from repro_torch.mesh import PartitionSpec as P
from repro_torch.models import Model
from repro_torch.models import parallel as TP
from repro_torch.sharding import native, rules
from repro_torch.sharding.act import activation_sharding
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as S

PyTree = Any
META = torch.device("meta")

# per-arch microbatch counts for train_4k (the reference's)
TRAIN_MICROBATCHES = {
    "default": 8,
    "deepseek-v2-236b": 16,
    "nemotron-4-15b": 8,
}


def sds(shape, dtype) -> torch.Tensor:
    """A shape/dtype stand-in: a meta tensor."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# input_specs — meta stand-ins for every model input
# ---------------------------------------------------------------------------

def input_specs(arch: str, shape_name: str) -> dict:
    """Meta-tensor stand-ins for the given cell's inputs (the reference's
    shapes and dtypes)."""
    return _input_specs_cfg(configs.get(arch), SHAPES[shape_name])


def _context(model: Model, batch: int) -> Optional[torch.Tensor]:
    ctx = model.context_inputs(batch)
    return None if ctx is None else sds(*ctx)


def _input_specs_cfg(cfg, cell: ShapeCell) -> dict:
    model = Model(cfg, use_kernels=False)
    out: dict = {}
    if cell.kind in ("train", "prefill"):
        extra = 1 if cell.kind == "train" else 0
        out["tokens"] = sds((cell.global_batch, cell.seq_len + extra),
                            torch.int32)
    else:  # decode
        out["token"] = sds((cell.global_batch,), torch.int32)
        out["index"] = sds((), torch.int32)
        out["cache"] = model.init_cache(cell.global_batch, cell.seq_len,
                                        device=META)
    ctx = _context(model, cell.global_batch)
    if ctx is not None:
        out["context"] = ctx
    return out


# ---------------------------------------------------------------------------
# cache sharding heuristics
# ---------------------------------------------------------------------------

def cache_specs(cache: PyTree, cfg, mesh, batch: int) -> PyTree:
    """Decode-cache shardings: [stack?, B, S|W, heads?, d] — batch over DP,
    a heads/width-like dim over TP when divisible."""
    dp = rules.dp_axes(mesh)
    dp_total = math.prod(mesh.shape[a] for a in dp)
    batch_ax = dp if batch % dp_total == 0 and batch > 1 else None
    tp_candidates = {cfg.n_kv_heads, cfg.n_heads, cfg.d_model // 64,
                     cfg.d_model, cfg.hybrid.lru_width or cfg.d_model}

    def one(path, leaf):
        ps = rules._path_str(path)
        stacked = ps.startswith("layers/")
        off = 1 if stacked else 0        # leading period-stack dim
        dims: list = [None] * len(leaf.shape)
        if len(leaf.shape) > off and leaf.shape[off] == batch:
            dims[off] = batch_ax
        for i in range(off + 2, len(leaf.shape)):
            d = leaf.shape[i]
            if d in tp_candidates and d % mesh.shape["model"] == 0:
                dims[i] = "model"
                break
        return P(*dims)

    return rules.map_with_path(one, cache)


# ---------------------------------------------------------------------------
# the counters
# ---------------------------------------------------------------------------

class _Bytes(TorchDispatchMode):
    """Operand-plus-result bytes of every op that is not a view, and the
    peak of the live bytes of the storages the run creates."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen: set = set()

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        self._seen.add(key)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        ins = [a for a in tree.tree_leaves((list(args),
                                            dict(kwargs or {})))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree.tree_leaves(
            list(out) if isinstance(out, (tuple, list)) else [out])
            if isinstance(o, torch.Tensor)]
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for o in outs:
            self._track(o)
        return out


class Counters:
    """FLOPs, bytes, peak live bytes and collectives of the run inside
    ``with Counters() as c:``."""

    def __enter__(self):
        self.flop = FlopCounterMode(display=False)
        self.bytes = _Bytes()
        self._log_cm = native.counting()
        self.log = self._log_cm.__enter__()
        self.flop.__enter__()
        self.bytes.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        self.bytes.__exit__(*exc)
        self.flop.__exit__(*exc)
        self._log_cm.__exit__(*exc)
        return False

    def per_rank(self, ranks: int) -> dict:
        from repro_torch.roofline.analysis import log_bytes
        coll = log_bytes(self.log)
        return {"flops": self.flop.get_total_flops() / ranks,
                "hbm_bytes": self.bytes.bytes / ranks,
                "coll_bytes": float(coll["total_bytes"]),
                "coll_detail": coll,
                "temp_bytes": self.bytes.peak / ranks}


# ---------------------------------------------------------------------------
# program builders per cell kind
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BuiltCell:
    arch: str
    shape: str
    mesh_desc: str
    kind: str
    counts: dict                 # per rank: flops, hbm_bytes, coll_bytes
    memory: dict                 # per rank: temp/argument/output/alias
    log: Any                     # the native collective log
    act: dict                    # shard_act pins
    seconds: float
    tp_plan: tuple = (False, False)


def _mesh_desc(mesh) -> str:
    return "x".join(f"{mesh.shape[a]}{a[0]}" for a in mesh.axis_names)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _tree_local_bytes(t: PyTree, specs: PyTree, mesh) -> int:
    return sum(_nbytes(rules.local_shape(x.shape, s, mesh), x.dtype)
               for x, s in zip(tree.tree_leaves(t), rules.spec_leaves(specs)))


def _resolve_cfg(arch, shape_name, remat, extra_config):
    cfg = configs.get(arch)
    overrides = dict(extra_config or {})
    if remat is not None:
        overrides["remat"] = remat
    if shape_name in ("prefill_32k", "decode_32k"):
        overrides.setdefault("max_seq", 32768)
    if shape_name == "long_500k":
        overrides.setdefault("max_seq", 524288)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def build_cell(arch: str, shape_name: str, mesh, *,
               microbatches: Optional[int] = None,
               remat: Optional[str] = None,
               extra_config: Optional[dict] = None) -> BuiltCell:
    """Run one cell's program on meta tensors over ``mesh`` (a meta
    :class:`~repro_torch.mesh.LocalMesh`) and count it."""
    ok, reason = applicable(arch, shape_name)
    if not ok:
        raise ValueError(f"{arch}×{shape_name}: {reason}")
    cfg = _resolve_cfg(arch, shape_name, remat, extra_config)
    cell = SHAPES[shape_name]
    if cell.kind == "train":
        mb = microbatches or TRAIN_MICROBATCHES.get(
            arch, TRAIN_MICROBATCHES["default"])
        return build_train(cfg, cell, mesh, microbatches=mb, arch=arch)
    return build_serve(cfg, cell, mesh, arch=arch)


def build_train(cfg, cell: ShapeCell, mesh, *, microbatches: int,
                arch: Optional[str] = None, optimizer=None) -> BuiltCell:
    """The GSPMD train step of ``cfg`` on ``cell``'s global batch over
    ``mesh``, run once on meta tensors (``mesh`` must be on ``meta``)."""
    model = Model(cfg, use_kernels=False)
    optimizer = optimizer or opt_lib.make_optimizer(cfg.optimizer)
    step = S.build_train_step_gspmd(model, optimizer, mesh,
                                    microbatches=microbatches)
    ins = _input_specs_cfg(cfg, cell)
    params = model.param_shapes()
    state = S.TrainState(params, optimizer.init(params),
                         torch.zeros((), dtype=torch.int32, device=META))
    state = step.place_state(state)
    batch = {k: ins[k] for k in ("tokens", "context") if k in ins}
    specs = step.state_specs
    state_bytes = _tree_local_bytes(params, specs.params, mesh) + \
        _tree_local_bytes(optimizer.init(params), specs.opt, mesh)
    dp = rules.dp_axes(mesh, cfg.parallelism)
    dp_total = math.prod(mesh.shape[a] for a in dp)
    batch_bytes = sum(x.numel() * x.element_size() for x in batch.values()) \
        // dp_total
    with Counters() as c:
        new_state, metrics = step(state, batch)
        del new_state, metrics
    counts = c.per_rank(mesh.n_ranks)
    memory = {"temp_bytes": counts.pop("temp_bytes"),
              "argument_bytes": state_bytes + batch_bytes,
              "output_bytes": state_bytes + 5 * 4,
              "alias_bytes": state_bytes}
    return BuiltCell(arch or cfg.name, cell.name, _mesh_desc(mesh), "train",
                     counts, memory, c.log, step.last["act"].summary(), c.seconds,
                     step.tp_plan)


def _gather_note(shape, stored, compute, mesh, dtype) -> None:
    """Log the all-gather that takes a leaf of global ``shape`` from its
    ``stored`` layout to its ``compute`` one, if it moves anything."""
    if set(a for e in stored for a in S._axes_of(e)) - \
            set(a for e in compute for a in S._axes_of(e)):
        native.note("all-gather", "fwd", (),
                    rules.local_shape(shape, compute, mesh), dtype)


class _RankHook(TP.TensorParallel):
    """One rank's program: each period of the stacked layers gathered to
    its compute layout as the scan reaches it (logged, a fresh meta
    tensor each, dropped after the period), a row-parallel partial's
    all-reduce over ``model`` logged (the value stands for the sum), and
    with expert-parallel banks (``ep``) the rank's slots sliced to its
    experts and their outputs' all-gather logged, and the load-balance
    means' all-reduce over the DP axes logged.  ``layers``: ``{path:
    (global shape, stored, compute)}`` of the stacked leaves, all
    without the layer dim."""

    def __init__(self, mesh, attn: bool, ffn: bool, layers: dict,
                 ep: bool):
        self.mesh, self.attn, self.ffn = mesh, attn, ffn
        self.layers, self.ep = layers, ep

    def moe_aux_means(self, me, ce):
        dp = rules.dp_axes(self.mesh)
        for x in (me, ce):
            native.note("all-reduce", "fwd", dp, x.shape, x.dtype)
        return me, ce

    def moe_dispatch(self, xem):
        if not self.ep:
            return xem
        return xem.narrow(-3, 0, xem.shape[-3] // self.mesh.shape["model"])

    def moe_combine(self, yem, shared_partial=None):
        if not self.ep:
            return yem, shared_partial
        shape = yem.shape[:-3] + (yem.shape[-3] * self.mesh.shape["model"],) \
            + yem.shape[-2:]
        native.note("all-gather", "fwd", ("model",), shape, yem.dtype)
        return sds(shape, yem.dtype), shared_partial

    def layer_params(self, pp, where):
        def one(path, x):
            shape, stored, compute = self.layers[where + path]
            _gather_note(shape, stored, compute, self.mesh, x.dtype)
            return sds(rules.local_shape(shape, compute, self.mesh),
                       x.dtype)
        return rules.map_with_path(one, pp)

    def _log(self, x):
        native.note("all-reduce", "fwd", ("model",), x.shape, x.dtype)
        return x

    def attn_reduce(self, h):
        return self._log(h) if self.attn else h

    def ffn_reduce(self, f):
        return self._log(f) if self.ffn else f


def _local(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    return sds(rules.local_shape(x.shape, spec, mesh), x.dtype)


def build_serve(cfg, cell: ShapeCell, mesh, *,
                arch: Optional[str] = None) -> BuiltCell:
    """One rank's prefill or decode program on meta tensors."""
    model = Model(cfg, use_kernels=False)
    attn_tp, ffn_tp = S.tp_plan(cfg, mesh)
    par = cfg.parallelism
    shapes = model.param_shapes()
    pairs = rules.leaves_with_paths(rules.param_specs(shapes, mesh, par))
    pflat = [s for _, s in pairs]
    cflat = [S.compute_spec(path, s, attn_tp, ffn_tp) for path, s in pairs]
    leaves, td = tree.tree_flatten(shapes)
    arg_bytes = sum(_nbytes(rules.local_shape(x.shape, s, mesh), x.dtype)
                    for x, s in zip(leaves, pflat))
    local_model = model
    if attn_tp:
        m = mesh.shape["model"]
        local_model = Model(dataclasses.replace(
            cfg, n_heads=cfg.n_heads // m, n_kv_heads=cfg.n_kv_heads // m,
            d_head=cfg.head_dim), use_kernels=False)
    ins = _input_specs_cfg(cfg, cell)
    dp = rules.dp_axes(mesh)
    dp_total = math.prod(mesh.shape[a] for a in dp)
    b = cell.global_batch
    b_local = b // dp_total if b % dp_total == 0 and b > 1 else b
    ctx = ins.get("context")
    if ctx is not None:
        ctx = sds((b_local,) + tuple(ctx.shape[1:]), ctx.dtype)
    layers = S.layer_layouts(pairs, cflat)
    hook = _RankHook(mesh, attn_tp, ffn_tp, {
        path: (tuple(x.shape[1:]),) + layers[path]
        for (path, _), x in zip(pairs, leaves) if path in layers},
        S.expert_parallel(pairs, cflat))
    with Counters() as c, activation_sharding(mesh, parallelism=par) as act:
        # the stacked layers' leaves as stored (the hook gathers one
        # period at a time), every other leaf gathered before the forward
        params = []
        for (path, s), x, cs in zip(pairs, leaves, cflat):
            if path in layers:
                params.append(_local(x, s, mesh))
                continue
            _gather_note(x.shape, s, cs, mesh, x.dtype)
            params.append(_local(x, cs, mesh))
        params = tree.tree_unflatten(td, params)
        with torch.no_grad(), TP.tensor_parallel(hook):
            if cell.kind == "prefill":
                toks = sds((b_local, cell.seq_len), torch.int32)
                hidden, _ = local_model.forward(params, toks, context=ctx)
                out = local_model.logits(params, hidden[:, -1:, :])[:, 0]
                out_bytes = out.numel() * out.element_size()
            else:
                cache = ins["cache"]
                cspecs = cache_specs(cache, cfg, mesh, b)
                cache = local_model.init_cache(b_local, cell.seq_len,
                                               device=META)
                arg_bytes += _tree_local_bytes(ins["cache"], cspecs, mesh)
                tok = sds((b_local,), torch.int32)
                lg, cache = local_model.decode_step(
                    params, tok, cache, 0, context=ctx)
                out_bytes = lg.numel() * lg.element_size() + \
                    sum(x.numel() * x.element_size()
                        for x in tree.tree_leaves(cache))
    counts = c.per_rank(1)
    memory = {"temp_bytes": counts.pop("temp_bytes"),
              "argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "alias_bytes": 0}
    return BuiltCell(arch or cfg.name, cell.name, _mesh_desc(mesh),
                     cell.kind, counts, memory, c.log, act.summary(),
                     c.seconds, (attn_tp, ffn_tp))


# ---------------------------------------------------------------------------
# linear probes — exact per-rank cost recovery at a fraction of the work.
#
# A cell's counts are exactly linear in (#periods, #microbatches) for these
# programs, so small probes at (1, 2) periods × (1, 2) microbatches give
# the per-period / per-microbatch / per-step components, and the full
# cell's count is their composition.
# ---------------------------------------------------------------------------

ANALYSIS_OVERRIDES = dict(scan_layers=False, analysis_unroll=True,
                          attn_chunk=4096, wkv_chunk=512)


def probe_layer_counts(cfg) -> tuple[int, int, int]:
    """(period_len, rem_len, n_periods_full) for the probe ladder."""
    from repro_torch.models.transformer import _period_of
    period, n_periods, rem = _period_of(cfg)
    return len(period), len(rem), n_periods


def build_probe(arch: str, shape_name: str, mesh, *,
                periods: int, microbatches: int = 1,
                extra_config: Optional[dict] = None) -> BuiltCell:
    cfg0 = configs.get(arch)
    plen, rlen, _ = probe_layer_counts(cfg0)
    cell = SHAPES[shape_name]
    overrides = dict(ANALYSIS_OVERRIDES)
    overrides.update(extra_config or {})
    overrides["n_layers"] = rlen + periods * plen
    if cell.kind == "train":
        mb_cell = TRAIN_MICROBATCHES.get(arch, TRAIN_MICROBATCHES["default"])
        probe_batch = cell.global_batch // mb_cell * microbatches
        probe_cell = dataclasses.replace(cell, global_batch=probe_batch)
        return _build_with_cell(arch, shape_name, probe_cell, mesh,
                                overrides, microbatches)
    return _build_with_cell(arch, shape_name, cell, mesh, overrides, 1)


def _build_with_cell(arch, shape_name, cell, mesh, overrides, microbatches):
    """build_cell with an overridden ShapeCell (probe machinery)."""
    orig = SHAPES[shape_name]
    try:
        SHAPES[shape_name] = cell
        return build_cell(arch, shape_name, mesh,
                          microbatches=microbatches,
                          extra_config=overrides)
    finally:
        SHAPES[shape_name] = orig


def compose_probe_costs(costs: dict, *, n_periods: int,
                        mb_cell: int, kind: str) -> dict:
    """Solve the linear system from probe costs and compose the full cell.

    ``costs``: {(periods, mb): {metric: value}}.  For serve kinds only
    (1,1) and (2,1) are needed; train adds (1,2) and (2,2).

      P(p, m) = O + m·E + p·(m·Lmb + Lstep)
    """
    out = {}
    metrics = costs[(1, 1)].keys()
    for met in metrics:
        p11 = costs[(1, 1)][met]
        p21 = costs[(2, 1)][met]
        if kind == "train":
            p12 = costs[(1, 2)][met]
            p22 = costs[(2, 2)][met]
            l_mb = (p22 - p12) - (p21 - p11)
            l_step = (p21 - p11) - l_mb
            e_mb = p12 - p11 - l_mb      # P12 - P11 = E + Lmb
            o = p11 - e_mb - l_mb - l_step
            total = (mb_cell * e_mb + n_periods * (mb_cell * l_mb + l_step)
                     + o)
        else:
            l_step = p21 - p11
            o = p11 - l_step
            total = o + n_periods * l_step
        out[met] = max(total, 0.0)
    return out


def probe_costs(built: BuiltCell) -> dict:
    """The three counts a probe contributes to the composition."""
    c = built.counts
    return {"flops": c["flops"], "hbm_bytes": c["hbm_bytes"],
            "coll_bytes": c["coll_bytes"]}
