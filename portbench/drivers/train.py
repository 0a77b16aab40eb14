"""Window driver of a training cell: the port's data-parallel train step
through the switch gradient sync (``build_train_step_acis``).

Set-up builds one step object (model, engine, AdamW, the train state
with its EF residual and persistent sync arenas) from the benchmark's
weights, makes a pool of batches on the device, and drives the step
through its first ``checked`` steps on the pool's first batches: they
warm up every shape and are the steps the reference follows.  From them
it keeps what the comparison reads: each step's loss, every rank's own
gradient of the first step (``local_grads``, the step's first stage,
called once more on the step's own state and batch just before it; a
host copy), the first gradient as AdamW got it (its first moment over
``1 - b1``; a host copy and each leaf's norm), each rank's norm of its
EF residual after the first step, and each leaf's norm of the
parameters' change over the checked steps.  The window then drives the
same object
on the pool, cycled; the host runs at most one step ahead of the device
(it waits for step ``i - 1`` after issuing step ``i``), as a loop that
logs the last step's loss does.

``train_tokens_per_s`` counts the loss's target tokens of every step of
the window over the time from the window's start to the end of its last
step.  With spans (the traced run) each step is composed as the step
function composes it, ``local_grads`` then ``sync_and_update``, with
CUDA events around each part.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from portbench.harness import counts, trace, traffic, weights
from portbench.reference.spec import param_spec
from portbench.reference.train import reference_steps


def program_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.models.config import EncDecConfig, ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in names}
    if "encdec" in kw:
        kw["encdec"] = EncDecConfig(**kw["encdec"])
    return ModelConfig(**kw)


class Cell:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.job = cell.cfg, cell.job
        self.tokens = self.job["ranks"] * self.job["rows_per_rank"] \
            * self.job["seq"]

    # -- set-up --------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.core import make_engine
        from repro_torch.mesh import LocalMesh
        from repro_torch.models import Model
        from repro_torch.train import step as S
        from repro_torch.train.optimizer import adamw

        job, dev = self.job, self.device
        self.S = S
        self.mesh = LocalMesh(job["mesh"], device=dev)
        self.model = Model(program_config(self.cfg))
        self.engine = make_engine(**job["engine"])
        self.opt = adamw(**job["optimizer"])
        w0 = weights.draw(param_spec(self.cfg), self.seed, dev)
        params = weights.nest(w0, self.model.param_shapes())
        like = S.grads_like(params, self.mesh)
        self.state = S.TrainState(
            params, self.opt.init(params),
            torch.zeros((), dtype=torch.int32, device=dev),
            self.engine.init_state(like),
            self.engine.init_arenas(like, mesh=self.mesh))
        self.step = S.build_train_step_acis(self.model, self.opt, self.mesh,
                                            self.engine)
        self.pool = traffic.train_pool(self.cfg, job, self.seed, dev)
        self.readings = self._checked_steps(w0)
        del w0
        trace.synchronize(dev)

    def _checked_steps(self, w0: dict) -> dict:
        b1 = self.job["optimizer"]["b1"]
        out: dict = {"loss": []}
        for s in range(self.job["checked"]):
            if s == 0:
                out["rank_grads"] = self._rank_grads(self.pool[0])
            self.state, m = self.step(self.state, self.pool[s])
            out["loss"].append(float(m["nll"] + m["z_loss"] + m["aux"]))
            if s == 0:
                first = {k: v.float() / (1.0 - b1) for k, v in
                         weights.paths_of(self.state.opt["m"]).items()}
                out["grad_norms"] = _norms(first)
                out["first_grad"] = {k: v.to("cpu") for k, v in
                                     first.items()}
                del first
                if self.state.ef_residual is not None:
                    out["residual_norms"] = _rank_norms(
                        weights.paths_of(self.state.ef_residual),
                        self.job["ranks"])
        now = weights.paths_of(self.state.params)
        out["update_norms"] = _norms({k: now[k].float() - w0[k].float()
                                      for k in now})
        return out

    def _rank_grads(self, batch) -> list:
        """Every rank's own gradient of ``batch`` on the current state:
        one host dict a rank, path -> tensor."""
        grads, _ = self.S.local_grads(self.model, self.state, batch,
                                      self.mesh)
        nd = self.mesh.rank_ndim
        flat = {k: v.reshape((-1,) + v.shape[nd:])
                for k, v in weights.paths_of(grads).items()}
        del grads
        return [{k: v[r].to("cpu") for k, v in flat.items()}
                for r in range(self.job["ranks"])]

    # -- the window ----------------------------------------------------------

    def _timed_step(self, batch, ev):
        S = self.S
        ev[0].record()
        grads, metrics = S.local_grads(self.model, self.state, batch,
                                       self.mesh)
        ev[1].record()
        self.state, _, _ = S.sync_and_update(self.engine, self.opt,
                                             self.state, grads, metrics,
                                             self.mesh)
        ev[2].record()

    def window(self, seconds: float, spans: bool = False) -> dict:
        cuda = self.device.type == "cuda"
        pool, n_pool = self.pool, len(self.pool)
        first = self.job["checked"]
        evs = []
        prev = None
        i = 0
        trace.synchronize(self.device)
        t0 = time.perf_counter()
        while True:
            batch = pool[(first + i) % n_pool]
            if spans and cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                self._timed_step(batch, ev)
                evs.append(ev)
                done = ev[2]
            else:
                self.state, _ = self.step(self.state, batch)
                done = None
                if cuda:
                    done = torch.cuda.Event()
                    done.record()
            if prev is not None:
                prev.synchronize()
            prev = done
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if prev is not None:
            prev.synchronize()
        wall = time.perf_counter() - t0
        win = {"attempted": i, "steps": i, "seconds": wall,
               "end_to_end": {"train_tokens_per_s": i * self.tokens / wall}}
        if evs:
            win["fwd_bwd_ms"] = [a.elapsed_time(b) for a, b, _ in evs]
            win["sync_update_ms"] = [b.elapsed_time(c) for _, b, c in evs]
        return win

    def profile(self, chrome=None) -> dict:
        first = self.job["checked"]
        pool = self.pool

        def one(i):
            with torch.profiler.record_function("portbench.train_step"):
                self.state, _ = self.step(self.state,
                                          pool[(first + i) % len(pool)])
        return trace.profiled(one, self.job["profile_steps"], chrome)

    def record(self, win: dict, prof) -> dict:
        rows = self.job["ranks"] * self.job["rows_per_rank"]
        return {"window": win, "trace": prof,
                "step_flops": counts.train_step_flops(self.cfg, rows,
                                                      self.job["seq"])}

    # -- the check -----------------------------------------------------------

    def free(self) -> None:
        """Drops the program's objects and its state."""
        for name in ("state", "step", "engine", "model", "opt", "mesh",
                     "pool", "S"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32", per_rank=None) -> dict:
        """The reference's readings of the checked steps, from the same
        weights and batches drawn again from the seed; ``per_rank`` as
        :func:`reference_steps` takes it."""
        dev = self.device
        w0 = weights.draw(param_spec(self.cfg), self.seed, dev)
        batches = traffic.train_pool(self.cfg, self.job, self.seed,
                                     dev)[:self.job["checked"]]
        return reference_steps(self.cfg, reference_job(self.job), w0,
                               batches, precision=precision,
                               per_rank=per_rank)

    def check(self) -> dict:
        """Frees the program's state, then holds its readings of the
        checked steps against the reference's."""
        from portbench.harness.compare import RankGradDiff, train_numbers

        self.free()
        diff = RankGradDiff(self.readings["rank_grads"])
        return train_numbers(self.readings, self.reference(per_rank=diff),
                             diff)


def reference_job(job: dict) -> dict:
    """What the reference needs of a training job."""
    eng = job["engine"]
    ef = eng.get("compressor") if "compressed" in eng["backend"] else None
    if ef not in (None, "int8_hopquant"):
        raise ValueError(f"the reference has no model of the {ef!r} sync")
    return {"ranks": job["ranks"], "optimizer": job["optimizer"],
            "ef_compressor": ef}


def _rank_norms(tensors: dict, ranks: int) -> list:
    """Each rank's norm over every leaf of rank-stacked ``tensors``."""
    sq = sum(x.float().reshape(ranks, -1).square().sum(1)
             for x in tensors.values())
    return sq.sqrt().tolist()


def _norms(tensors: dict, scale: float = 1.0) -> dict:
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[k].float())
                        for k in names]) * scale
    return dict(zip(names, vals.tolist()))
