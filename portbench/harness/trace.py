"""A profiled window and what the benchmark reads from it.

The device's busy time is the union of its operations' intervals (two
operations that overlap on different streams count once), not their
sum.  The breakdown names the device operations that took most time and
the longest idle gaps by the host operation running under them (the
innermost one, runtime API calls left out).  Labels
(``record_function``) name spans of the Chrome trace only.  The Chrome
trace is written beside the run's other outputs.
"""

from __future__ import annotations

import heapq
import time
from pathlib import Path
from typing import Callable, Optional

import torch

TOP = 10


def synchronize(device) -> None:
    """Waits for ``device``'s work (nothing to wait for on the host)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def idle_share_pct(record: dict):
    """The device's idle share over a run's profiled window, %: 1 - (the
    union of the device operations' intervals) / (the host-clock
    window); None without a trace."""
    prof = record.get("trace")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def union_us(intervals: list[tuple[float, float]]) -> tuple[float, list]:
    """(total length, the merged intervals) of ``[(start, end), ...]``."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def idle_gaps_by_host_op(merged: list, host: list[tuple[float, float, str]]
                         ) -> dict:
    """Seconds of idle time between consecutive device intervals, summed
    by the innermost host operation (latest start) covering each gap's
    middle; ``host`` is ``[(start_us, end_us, name), ...]``."""
    gaps = sorted(((a[1] + b[0]) / 2, b[0] - a[1])
                  for a, b in zip(merged, merged[1:]) if b[0] > a[1])
    host = sorted(host)
    heap: list = []
    j = 0
    out: dict = {}
    for mid, length in gaps:
        while j < len(host) and host[j][0] <= mid:
            s, e, name = host[j]
            heapq.heappush(heap, (-s, e, name))
            j += 1
        while heap and heap[0][1] <= mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "(no host op)"
        out[name] = out.get(name, 0.0) + length / 1e6
    return out


def top(by_name: dict, n: int = TOP) -> list:
    return [[k[:200], v] for k, v in sorted(by_name.items(),
                                            key=lambda kv: -kv[1])[:n]]


def profiled(fn: Callable[[int], None], count: int,
             chrome: Optional[Path] = None) -> dict:
    """``fn(i)`` for ``i < count`` under ``torch.profiler``, synchronised
    at both ends.  Returns ``window_s`` (host clock), ``busy_s`` (union
    of device operations), ``ops`` (device operations launched),
    ``device_ops`` and ``idle_gaps`` (each the top entries, seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(count):
            fn(i)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, host, by_name = [], [], {}
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if getattr(e, "is_user_annotation", False):
            continue        # a label's span, not work
        if e.device_type == DeviceType.CUDA:
            dev.append((s, t))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) / 1e6
        elif not e.name.startswith("cu"):
            host.append((s, t, e.name))
    busy_us, merged = union_us(dev)
    if chrome is not None:
        chrome.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(chrome))
    return {"window_s": window_s, "busy_s": busy_us / 1e6, "ops": len(dev),
            "count": count, "device_ops": top(by_name),
            "idle_gaps": top(idle_gaps_by_host_op(merged, host))}
