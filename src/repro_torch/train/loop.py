"""Fault-tolerant training loop: checkpoint/restart, preemption handling,
fault injection.

The port of :mod:`repro.train.loop`, its contract unchanged: every side
effect that matters for recovery is ordered so that a kill at any point
resumes bit-exactly — the data position is a pure function of the
restored step, the optimizer state travels with the params, and the
error-feedback residual is part of the checkpointed state (losing the
look-aside memory would lose gradient mass).  The stream's numpy batches
move to the step's mesh device here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.data.pipeline import BigramStream
from repro_torch.train.step import TrainState

PyTree = Any


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    keep_last: int = 3
    log_every: int = 10
    # straggler / fault injection (tests + chaos drills)
    fail_at_step: Optional[int] = None


class Preempted(RuntimeError):
    pass


class TrainLoop:
    def __init__(self, step_fn: Callable, stream: BigramStream,
                 cfg: LoopConfig, *,
                 batch_transform: Optional[Callable] = None):
        self.step_fn = step_fn
        self.stream = stream
        self.cfg = cfg
        self.batch_transform = batch_transform or (lambda b, s: b)
        self._preempt = False
        self.metrics_log: list[dict] = []
        mesh = getattr(step_fn, "mesh", None)
        self.device = mesh.device if mesh is not None else None

    def request_preempt(self, *_):
        """SIGTERM-style graceful stop: finish the step, checkpoint, exit."""
        self._preempt = True

    def maybe_restore(self, state: TrainState, device=None) -> TrainState:
        d = self.cfg.ckpt_dir
        if d and ckpt.latest_step(d) is not None:
            state, _, _ = ckpt.restore(
                d, state, device=device if device is not None
                else self.device)
        return state

    def run(self, state: TrainState) -> TrainState:
        cfg = self.cfg
        start = int(state.step)
        for step in range(start, cfg.total_steps):
            if cfg.fail_at_step is not None and step == cfg.fail_at_step:
                raise RuntimeError(f"injected fault at step {step}")
            batch = self.batch_transform(self.stream.batch(step), step)
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in batch.items()}
            state, metrics = self.step_fn(state, batch)
            if step % cfg.log_every == 0 or step == cfg.total_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                self.metrics_log.append(m)
            if cfg.ckpt_dir and (step + 1) % cfg.ckpt_every == 0:
                ckpt.save(cfg.ckpt_dir, step + 1, state,
                          keep_last=cfg.keep_last)
            if self._preempt:
                if cfg.ckpt_dir:
                    ckpt.save(cfg.ckpt_dir, step + 1, state,
                              keep_last=cfg.keep_last)
                raise Preempted(f"preempted after step {step}")
        return state


def run_with_restarts(make_loop: Callable[[], tuple["TrainLoop", TrainState]],
                      max_restarts: int = 3) -> tuple[TrainState, int]:
    """Supervisor: restart-from-checkpoint on failure (the single-process
    stand-in for a cluster controller rescheduling dead pods)."""
    restarts = 0
    while True:
        loop, state = make_loop()
        state = loop.maybe_restore(state)
        try:
            return loop.run(state), restarts
        except Preempted:
            raise
        except RuntimeError:
            restarts += 1
            if restarts > max_restarts:
                raise
