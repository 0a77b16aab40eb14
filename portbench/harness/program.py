"""The port's own spans in a profiled pass, and what is read from them.

A second profiled pass runs the cell's ``profile_steps`` or
``profile_calls`` again, as the first pass runs them, with the port's
span log on (``repro_torch.obs.recording(spans=True)``): every ``acis.*``
span is then a ``record_function`` range on the profiler's clock, beside
the device's kernels.  Its Chrome trace is written as
``<cell>.program.trace.json`` and read back here.

The attribution rule (:func:`attribute`):

  * a device operation belongs to the innermost ``acis.*`` span whose
    host range contains the runtime call that launched it (matched by
    the correlation id), whatever thread made the call: autograd
    launches the backward's operations from a thread of its own, inside
    the caller's ``acis.train.backward`` range on the clock but outside
    it in the profiler's tree;
  * a span's device ms is the union of the intervals of the operations
    that belong to it or to a span inside it, per step or call;
  * an idle gap between the device's merged intervals is charged to the
    innermost span under its midpoint (the rule
    :func:`portbench.harness.trace.idle_gaps_by_host_op` applies to
    ``aten`` operations).

The readers (:data:`READERS`) take a run's record and return None when it
has no ``program`` key, or when the key holds nothing they read.  With a
program that has no span log :func:`second_pass` returns None.
"""

from __future__ import annotations

import heapq
import json
from pathlib import Path
from typing import Callable, Optional

from portbench.harness import counts
from portbench.harness.trace import union_us

PREFIX = "acis."
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = ("cuda_runtime", "cuda_driver")
RING = ("acis.stage.allreduce", "acis.stage.batched_allreduce",
        "acis.stage.ef_allreduce")
PACK = "acis.stage.map.bucket_pack"
STAGE = "acis.stage."
TRAIN_ROOT = "acis.train.step"
SYNC_ROOT = "acis.sync.call"


def second_pass(profile: Callable[[Optional[Path]], dict],
                chrome: Path) -> Optional[dict]:
    """``profile(chrome)`` (a ``Cell.profile`` of ``drivers/``) under the port's
    span log; returns the ``program`` record (:func:`attribute` of its
    Chrome trace, the log's counters, the pass's ``window_s``,
    ``busy_s``, ``ops`` and ``count``), or None for a program without a
    span log."""
    from repro_torch import obs
    from repro_torch.obs import spans

    if not hasattr(spans, "span"):
        return None
    with obs.recording(spans=True) as rec:
        prof = profile(chrome)
    out = attribute(json.loads(Path(chrome).read_text())["traceEvents"])
    out["counters"] = dict(rec.counters)
    out["span_device_ms"] = _event_ms(rec.spans)
    out["pass"] = {k: prof[k] for k in ("window_s", "busy_s", "ops",
                                        "count")}
    return out


def _event_ms(log: list) -> dict:
    """Each span name's CUDA-event device ms, summed over the log."""
    out: dict = {}
    for s in log:
        if s.device_ms is not None:
            out[s.name] = out.get(s.name, 0.0) + s.device_ms
    return out


def _innermost(spans: list, times: list) -> list:
    """For each time, the index of the innermost span (the latest start)
    whose range ``[start, end)`` holds it, or None; ``spans`` are
    ``(start, end, ...)`` sorted by start, then by end descending."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out: list = [None] * len(times)
    heap: list = []
    j = 0
    for q in order:
        t = times[q]
        while j < len(spans) and spans[j][0] <= t:
            heapq.heappush(heap, (-spans[j][0], -j, spans[j][1]))
            j += 1
        while heap and heap[0][2] <= t:
            heapq.heappop(heap)
        out[q] = -heap[0][1] if heap else None
    return out


def attribute(events: list) -> dict:
    """Chrome trace events -> ``spans`` (``[name, start_us, end_us,
    parent]``, ``acis.*`` ranges sorted by start, ``parent`` the
    enclosing span's index or None), ``ops`` (``[start_us, end_us, name,
    span]``: each device operation and its span by the rule above, or
    None) and ``gaps`` (``[length_us, span]``)."""
    spans, launch, dev = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation" and e["name"].startswith(PREFIX):
            spans.append((ts, ts + dur, e["name"]))
        elif cat in LAUNCH and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = ts
        elif cat in DEVICE:
            dev.append((ts, ts + dur, e["name"],
                        e.get("args", {}).get("correlation")))
    spans.sort(key=lambda s: (s[0], -s[1]))
    parents: list = []
    stack: list = []
    for i, (s, t, _) in enumerate(spans):
        while stack and not (spans[stack[-1]][0] <= s
                             and t <= spans[stack[-1]][1]):
            stack.pop()
        parents.append(stack[-1] if stack else None)
        stack.append(i)
    at = [launch.get(c) for _, _, _, c in dev]
    known = [i for i, t in enumerate(at) if t is not None]
    owner: list = [None] * len(dev)
    for i, o in zip(known, _innermost(spans, [at[i] for i in known])):
        owner[i] = o
    _, merged = union_us([(s, t) for s, t, _, _ in dev])
    gaps = [((a[1] + b[0]) / 2, b[0] - a[1])
            for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    gap_owner = _innermost(spans, [m for m, _ in gaps])
    return {"spans": [[n, s, t, p] for (s, t, n), p in zip(spans, parents)],
            "ops": [[s, t, n, o] for (s, t, n, _), o in zip(dev, owner)],
            "gaps": [[length, o] for (_, length), o in zip(gaps, gap_owner)]}


def _chain(prog: dict, i: Optional[int]) -> list:
    """Names of span ``i`` and the spans around it, innermost first."""
    out = []
    while i is not None:
        name, _, _, i = prog["spans"][i]
        out.append(name)
    return out


def _stage(names: list) -> Optional[str]:
    return next((n for n in names if n.startswith(STAGE)), None)


def _roots(prog: dict, root: str) -> int:
    return sum(1 for n, _, _, p in prog["spans"] if n == root and p is None)


def device_ms(record: dict, root: str,
              keep: Callable[[list], bool]) -> Optional[float]:
    """The union of the device intervals of the operations whose span
    chain ``keep`` takes, ms a ``root`` span (a step or a call)."""
    prog = record.get("program")
    n = _roots(prog, root) if prog else 0
    if not n:
        return None
    total, _ = union_us([(s, t) for s, t, _, o in prog["ops"]
                         if o is not None and keep(_chain(prog, o))])
    return total / 1e3 / n


def idle_ms(record: dict, root: str,
            keep: Callable[[list], bool]) -> Optional[float]:
    """Idle device ms a ``root`` span in the gaps whose span chain
    ``keep`` takes."""
    prog = record.get("program")
    n = _roots(prog, root) if prog else 0
    if not n:
        return None
    return sum(length for length, o in prog["gaps"]
               if o is not None and keep(_chain(prog, o))) / 1e3 / n


def kernel_roofline(record: dict, counter: str,
                    kernel: Callable[[str], bool]) -> Optional[float]:
    """The bytes the program counted under ``counter`` at the card's
    published bandwidth over the device time of the launches whose name
    ``kernel`` takes, %: the byte-weighted share over all of them."""
    prog = record.get("program")
    if not prog or not prog["counters"].get(counter):
        return None
    busy_us = sum(t - s for s, t, name, _ in prog["ops"] if kernel(name))
    if busy_us <= 0:
        return None
    try:
        _, bw = counts.peaks(record["device_kind"])
    except KeyError:
        return None
    return 100.0 * prog["counters"][counter] / bw / (busy_us / 1e6)


def by_span(record: dict, root: str) -> dict:
    """``{span name: [device ms, idle ms]}`` a ``root`` span, each
    operation and gap charged to its innermost span alone (``(none)``
    outside every span)."""
    prog = record.get("program")
    n = _roots(prog, root) if prog else 0
    if not n:
        return {}
    name = lambda o: "(none)" if o is None else prog["spans"][o][0]
    ops: dict = {}
    for s, t, _, o in prog["ops"]:
        ops.setdefault(name(o), []).append((s, t))
    out = {k: [union_us(v)[0] / 1e3 / n, 0.0] for k, v in ops.items()}
    for length, o in prog["gaps"]:
        out.setdefault(name(o), [0.0, 0.0])[1] += length / 1e3 / n
    return out


def _in(name: str) -> Callable[[list], bool]:
    return lambda names: name in names


def _hop(name: str) -> bool:
    return "hop_kernel" in name and "quant_hop_kernel" not in name


READERS: dict = {
    "forward_ms.train": lambda r: device_ms(r, TRAIN_ROOT,
                                            _in("acis.train.forward")),
    "backward_ms.train": lambda r: device_ms(r, TRAIN_ROOT,
                                             _in("acis.train.backward")),
    "step_sync_ms.train": lambda r: device_ms(r, TRAIN_ROOT,
                                              _in("acis.train.sync")),
    "optimizer_ms.train": lambda r: device_ms(r, TRAIN_ROOT,
                                              _in("acis.train.update")),
    "quant_hop_roofline.train": lambda r: kernel_roofline(
        r, "kernel.quant_hop.bytes", lambda n: "quant_hop_kernel" in n),
    "ring_ms.sync": lambda r: device_ms(
        r, SYNC_ROOT, lambda names: _stage(names) in RING),
    "pack_ms.sync": lambda r: device_ms(
        r, SYNC_ROOT, lambda names: _stage(names) == PACK),
    "epilogue_ms.sync": lambda r: device_ms(
        r, SYNC_ROOT, lambda names: _stage(names) not in RING + (PACK, None)),
    "stage_idle_ms.sync": lambda r: idle_ms(
        r, SYNC_ROOT, lambda names: names[0].startswith(STAGE)),
    "between_stages_idle_ms.sync": lambda r: idle_ms(
        r, SYNC_ROOT, lambda names: names[0] == SYNC_ROOT),
    "hop_roofline.sync": lambda r: kernel_roofline(
        r, "kernel.fused_hop.bytes", _hop),
}
