"""Topology-aware (hierarchical, multi-pod) collective schedules.

The PyTorch counterpart of :mod:`repro.core.topology`.  The paper places
compute at the *center* of the network because that is where flows
converge; on a multi-pod system the converging point is the thin
inter-pod fabric.  The hierarchical schedule maps ACiS onto that
asymmetry:

    1. intra-pod reduce-scatter over the fast ``data`` axis,
    2. inter-pod exchange over the thin ``pod`` axis on 1/|data|-size
       shards — optionally through a lossy wire codec (compress exactly
       where the wire is thin),
    3. intra-pod all-gather.

The schedule is not hand-written here: :func:`hierarchical_all_reduce`
traces ``reduce(x, axis="auto")`` and compiles it through
``engine.compile``, and the LowerTopology pass emits the RS/AR/AG triple
(with the codec riding the outer hop).  Everything is rank-local: call
inside ``with LocalMesh({"pod": ..., "data": ...}):`` on rank-stacked
tensors.
"""

from __future__ import annotations

import collections
import os
import warnings
from typing import Optional

import torch

from repro_torch.core.types import ADD, Monoid, TensorSpec
from repro_torch.core.wire import IDENTITY, WireCodec
from repro_torch.mesh import LocalMesh, current
from repro_torch.obs import metrics as _obs

# (inner, outer, monoid.name, codec.name, mean, local shape, dtype, axis
# sizes, config key) → CompiledProgram.  Keyed by *names* so per-call codec
# instances (int8_codec() is deliberately fresh per call) still hit.
#
# Bounded LRU: a long-running process sees an open-ended stream of
# (shape, dtype, mesh-size) keys, and each entry pins a compiled program;
# least-recently-used entries are evicted past the size knob, and
# evictions are counted (``topology.compile_cache_evicted``).
_COMPILE_CACHE: "collections.OrderedDict" = collections.OrderedDict()

_COMPILE_CACHE_SIZE = int(os.environ.get("ACIS_TOPOLOGY_CACHE_SIZE", "128"))


def compile_cache_size() -> int:
    return _COMPILE_CACHE_SIZE


def set_compile_cache_size(n: int) -> int:
    """Set the LRU capacity (``$ACIS_TOPOLOGY_CACHE_SIZE`` seeds the
    default); returns the previous value.  Shrinking evicts immediately."""
    global _COMPILE_CACHE_SIZE
    prev, _COMPILE_CACHE_SIZE = _COMPILE_CACHE_SIZE, int(n)
    _cache_trim()
    return prev


def _cache_get(key):
    hit = _COMPILE_CACHE.get(key)
    if hit is not None:
        _COMPILE_CACHE.move_to_end(key)
    return hit


def _cache_put(key, compiled):
    _COMPILE_CACHE[key] = compiled
    _COMPILE_CACHE.move_to_end(key)
    _cache_trim()
    return compiled


def _cache_trim():
    while len(_COMPILE_CACHE) > max(_COMPILE_CACHE_SIZE, 0):
        _COMPILE_CACHE.popitem(last=False)
        _obs.RECORDER.count("topology.compile_cache_evicted")


def hierarchical_all_reduce(
    x: torch.Tensor,
    *,
    inner_axis: str = "data",
    outer_axis: Optional[str] = "pod",
    monoid: Monoid = ADD,
    outer_codec: WireCodec = IDENTITY,
    backend: str = "acis",
    mean: bool = False,
) -> torch.Tensor:
    """RS(inner) → AR(outer, coded) → AG(inner), via the compiled pipeline.

    Wire accounting per element: 2·(d-1)/d intra-pod + 2·(p-1)/p·ratio/d
    inter-pod, vs a flat AR over d·p ranks pushing 2·(dp-1)/dp through the
    *thin* links too.  The inter-pod bytes drop by d× (and by codec ratio).

    ``backend`` is kept for signature compatibility; the emitted stages
    always run the explicit acis ring schedules.
    """
    from repro_torch.core import api, tracing

    del backend
    tp = current()
    sizes = api.live_axis_sizes((inner_axis, outer_axis))
    engine = api.make_engine("acis", inner_axis=inner_axis,
                             outer_axis=outer_axis)
    shape = tp.local_shape(x)
    key = (inner_axis, outer_axis, monoid.name, outer_codec.name, mean,
           shape, str(x.dtype), tuple(sorted(sizes.items())),
           engine.config.cache_key())
    compiled = _cache_get(key)
    if compiled is None:

        def _mean(y):
            t = current()
            n = t.axis_size(inner_axis)
            if outer_axis is not None:
                n = n * t.axis_size(outer_axis)
            return y / n

        def prog(v):
            if outer_codec is not IDENTITY and outer_axis is not None:
                # the codec rides the thin outer hop only (and there is no
                # outer hop to compress on a single-pod topology)
                v = tracing.wire(outer_codec, v)
            r = tracing.reduce(v, monoid, axis="auto")
            return tracing.map(_mean, r, name="mean") if mean else r

        compiled = _cache_put(key, engine.compile(
            prog, in_avals=(TensorSpec(shape, x.dtype),),
            axis_size=sizes or None))
    return compiled(x)[0]


def masked_all_reduce(
    x: torch.Tensor,
    alive: torch.Tensor,
    axis_name: str,
    *,
    renormalize: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Straggler-tolerant mean-reduce: ranks with ``alive == False`` are
    treated as missing (their contribution masked to the identity) and the
    mean is renormalized by the live count.  ``alive`` holds one flag a
    rank (``[*rank]``).

    .. deprecated::
        Thin wrapper over the compiled :func:`repro_torch.core.tracing.
        masked_reduce` path — the live count rides in the payload's flat
        ring buffer (one collective launch).  New code should call
        ``tracing.masked_reduce`` inside a traced program.

    Returns (mean, live_count); the count is clamped to ≥1 so a transient
    all-dead view cannot divide by zero.
    """
    warnings.warn(
        "topology.masked_all_reduce is deprecated: use tracing."
        "masked_reduce (compiled, one launch) or gradient_sync("
        "membership=...)", DeprecationWarning, stacklevel=2)
    from repro_torch.core import api, tracing

    tp = current()
    sizes = api.live_axis_sizes((axis_name,))
    engine = api.make_engine("acis", inner_axis=axis_name)
    shape = tp.local_shape(x)
    key = ("masked", axis_name, renormalize, shape, str(x.dtype),
           tuple(sorted(sizes.items())), engine.config.cache_key())
    compiled = _cache_get(key)
    if compiled is None:

        def prog(v, a):
            return tracing.masked_reduce(v, a, ADD, axis=axis_name,
                                         renormalize=renormalize)

        compiled = _cache_put(key, engine.compile(
            prog,
            in_avals=(TensorSpec(shape, x.dtype),
                      TensorSpec((), torch.float32)),
            axis_size=sizes or None))
    flag = torch.as_tensor(alive, device=x.device).to(torch.float32) \
        .reshape(tp.rank_shape)
    total, count = compiled(x, flag)
    return total, count


def pod_aware_axes(mesh: LocalMesh) -> tuple[str, Optional[str]]:
    """(inner, outer) DP axes for a mesh — outer is None on single-pod."""
    outer = "pod" if "pod" in mesh.axis_names else None
    return "data", outer
