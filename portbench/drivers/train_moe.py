"""Window driver of a training cell of the ``moe`` family with latent
attention (DeepSeek-V2-Lite): :mod:`portbench.drivers.train`'s set-up,
window, profile and check, with this family's program configuration,
parameter layout (:mod:`portbench.reference.moe`), FLOP count and
reference.

A row holds ``seq`` tokens, or the configuration's ``max_seq`` where
that is shorter (the context the model is trained at).  The traced run
also runs the profiled steps a second time under the port's span log
(:func:`portbench.harness.program.second_pass`), for the metrics that
read the port's spans and counters (``program`` in the record); its
``step_flops`` then count the held experts' products over the (token,
choice) pairs that reached them in that pass (``moe.routed_pairs``),
not over a uniform router's share.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.drivers import train
from portbench.harness import manifest, program, trace, traffic, weights
from portbench.reference.moe import param_spec, reference_steps


def program_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file of this family."""
    from repro_torch.models.config import (MLAConfig, ModelConfig, MoEConfig,
                                           YarnConfig)

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in names}
    mla = dict(cfg["mla"])
    if mla.get("yarn"):
        mla["yarn"] = YarnConfig(**mla["yarn"])
    kw["mla"] = MLAConfig(**mla)
    kw["moe"] = MoEConfig(**cfg["moe"])
    return ModelConfig(**kw)


def forward_flops(cfg: dict, seq: int, routed: float = None) -> float:
    """Model FLOPs of one row's forward over ``seq`` tokens: every
    projection, the dense and shared FFNs, the router, the logits, the
    held experts' FFNs over ``routed`` (token, choice) pairs a MoE layer
    (by default as many as a uniform router sends: ``seq · k · n_held /
    E``), and causal attention's scores and weighted sum over
    ``seq(seq+1)/2`` pairs a head (``2 (d_qk + d_v)`` a pair)."""
    d, h, v, n = cfg["d_model"], cfg["n_heads"], cfg["vocab"], cfg["n_layers"]
    m, e = cfg["mla"], cfg["moe"]
    qk = m["nope_head_dim"] + m["rope_head_dim"]
    attn = d * h * qk + d * (m["kv_lora"] + m["rope_head_dim"]) \
        + m["kv_lora"] * h * (m["nope_head_dim"] + m["v_head_dim"]) \
        + h * m["v_head_dim"] * d
    pairs = seq * (seq + 1) // 2
    macs = seq * (n * attn + 3 * d * cfg["d_ff"] + d * v)
    macs += (n - 1) * seq * (3 * d * e["d_ff_shared"] + d * e["n_experts"])
    flops = 2 * macs + n * 2 * pairs * h * (qk + m["v_head_dim"])
    expert = (n - 1) * 2 * 3 * d * e["d_ff_expert"]
    if routed is None:
        return flops + seq * e["top_k"] * e["n_held"] * expert \
            // e["n_experts"]
    return flops + routed * expert


def train_step_flops(cfg: dict, rows: int, seq: int,
                     routed: float = None) -> float:
    return 3 * rows * forward_flops(cfg, seq, routed)


def routed_per_row(prog: dict, rows: int):
    """The (token, choice) pairs a row and MoE layer that reached the held
    experts in a second pass's ``program`` record: its
    ``moe.routed_pairs`` over its ``acis.moe.route`` spans (one a layer's
    forward, the recompute's included) and the rows of a step; None
    where the pass counted none."""
    calls = sum(1 for name, *_ in prog["spans"] if name == "acis.moe.route")
    pairs = prog["counters"].get("moe.routed_pairs")
    return None if not calls or pairs is None else pairs / calls / rows


class Cell(train.Cell):
    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        self.job = dict(self.job, seq=min(self.job["seq"],
                                          self.cfg["max_seq"]))
        self.tokens = self.job["ranks"] * self.job["rows_per_rank"] \
            * self.job["seq"]

    def setup(self) -> None:
        from repro_torch.core import make_engine
        from repro_torch.mesh import LocalMesh
        from repro_torch.models import Model
        from repro_torch.train import step as S
        from repro_torch.train.optimizer import adamw

        job, dev = self.job, self.device
        self.S = S
        self.model = Model(program_config(self.cfg))
        self.mesh = LocalMesh(job["mesh"], device=dev)
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

    def record(self, win: dict, prof) -> dict:
        rows = self.job["ranks"] * self.job["rows_per_rank"]
        out = {"window": win, "trace": prof,
               "step_flops": train_step_flops(self.cfg, rows,
                                              self.job["seq"])}
        if prof is not None:
            out_dir = manifest.BENCH / "out"
            out_dir.mkdir(parents=True, exist_ok=True)
            prog = out["program"] = program.second_pass(
                self.profile, out_dir / f"{self.cell.name}.program.trace.json")
            routed = None if prog is None else routed_per_row(prog, rows)
            if routed is not None:
                out["step_flops"] = train_step_flops(
                    self.cfg, rows, self.job["seq"], routed)
        return out

    def reference(self, precision: str = "float32", per_rank=None) -> dict:
        dev = self.device
        w0 = weights.draw(param_spec(self.cfg), self.seed, dev)
        batches = traffic.train_pool(self.cfg, self.job, self.seed,
                                     dev)[:self.job["checked"]]
        return reference_steps(self.cfg, train.reference_job(self.job), w0,
                               batches, precision=precision,
                               per_rank=per_rank)
