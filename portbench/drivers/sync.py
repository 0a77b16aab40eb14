"""Window driver of a gradient-sync cell: the port's
``CollectiveEngine.gradient_sync`` alone, blocking calls back to back.

Set-up makes a pool of rank-stacked gradient trees of the
configuration's layout on the device (``pool`` inputs, each every
rank's copy of every leaf, in the leaves' dtypes), the engine and its
persistent arenas, and makes ``warmup`` calls.  In the window each call
takes the pool's next input, is issued and then synchronised, as
``MPI_Allreduce`` returns, and is timed on the host clock from its issue
to its synchronise.  ``sync_ms`` is the window's time over its calls;
``sync_p95_ms`` the 95th percentile of the calls' times.

The calls whose answers are checked are drawn from the seed among the
first ``sample_range`` calls (``samples`` of them), plus the window's
last call; each one's output is copied aside after its synchronise.
"""

from __future__ import annotations

import gc
import math
import random
import time

import torch

from portbench.harness import counts, trace, weights
from portbench.harness.seeds import sub_seed
from portbench.reference.spec import param_spec
from portbench.reference.sync import mean_over_ranks, widest_gap


def p95(values: list) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


class Cell:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.job = cell.cfg, cell.job
        self.spec = param_spec(self.cfg)

    def _input(self, k: int) -> dict:
        return weights.draw_grads(self.spec, self.job["ranks"], self.seed, k,
                                  self.device, self.job["std"])

    def setup(self) -> None:
        from repro_torch.core import make_engine
        from repro_torch.mesh import LocalMesh

        job = self.job
        self.mesh = LocalMesh(job["mesh"], device=self.device)
        self.engine = make_engine(**job["engine"])
        self.pool = [self._nest(self._input(k)) for k in range(job["pool"])]
        self.arenas = self.engine.init_arenas(self.pool[0], mesh=self.mesh)
        rng = random.Random(sub_seed(self.seed, "sample"))
        self.sample = set(rng.sample(range(job["sample_range"]),
                                     job["samples"]))
        for i in range(job["warmup"]):
            self._call(i)
            trace.synchronize(self.device)

    def _nest(self, flat: dict) -> dict:
        layout = {}
        for path, x in flat.items():
            node = layout
            *heads, last = path.split(".")
            for h in heads:
                node = node.setdefault(h, {})
            node[last] = x
        return layout

    def _call(self, i: int):
        out, _, self.arenas = self.engine.gradient_sync(
            self.pool[i % len(self.pool)], None, arenas=self.arenas,
            mesh=self.mesh)
        return out

    def window(self, seconds: float, spans: bool = False) -> dict:
        times, kept = [], {}
        i = 0
        trace.synchronize(self.device)
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            out = self._call(i)
            trace.synchronize(self.device)
            b = time.perf_counter()
            times.append(b - a)
            if i in self.sample:
                kept[i] = _copy(out)
                trace.synchronize(self.device)
            i += 1
            if b - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        kept[i - 1] = _copy(out)
        self.kept = kept
        return {"attempted": i, "calls": i, "seconds": wall,
                "end_to_end": {"sync_ms": wall / i * 1e3,
                               "sync_p95_ms": p95(times) * 1e3}}

    def profile(self, chrome=None) -> dict:
        def one(i):
            with torch.profiler.record_function("portbench.gradient_sync"):
                self._call(i)
                torch.cuda.synchronize()
        return trace.profiled(one, self.job["profile_calls"], chrome)

    def record(self, win: dict, prof) -> dict:
        eng = self.job["engine"]
        return {"window": win, "trace": prof,
                "least_bytes": counts.sync_least_bytes(
                    self.cfg, self.job["ranks"],
                    residual="compressed" in eng["backend"])}

    def free(self) -> dict:
        """Drops the engine, its arenas and the pool; returns the kept
        outputs by call."""
        kept = self.kept
        self.pool = self.arenas = self.engine = self.mesh = self.kept = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return kept

    def check(self) -> dict:
        """Holds every kept call's output, every rank, against the
        float32 mean of its input drawn again from the seed."""
        kept = self.free()
        worst = 0.0
        by_input: dict = {}
        for i in sorted(kept):
            by_input.setdefault(i % self.job["pool"], []).append(kept[i])
        for k, outs in sorted(by_input.items()):
            x = self._input(k)
            for out in outs:
                got = weights.paths_of(out)
                if set(got) != set(x):
                    return {"sync_gap": math.inf}
                for path, xs in x.items():
                    worst = max(worst, widest_gap(got[path],
                                                  mean_over_ranks(xs)))
            del x
        return {"sync_gap": worst}


def _copy(out: dict) -> dict:
    return {k: _copy(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in out.items()}
