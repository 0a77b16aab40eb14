"""Deterministic synthetic data pipeline (host-sharded, resumable).

The port's copy of :mod:`repro.data.pipeline`, numpy only, so a batch is
the same bytes in both packages.  A seeded ground-truth bigram language
(fixed transition table) generates token streams, so training has real
learnable structure (the loss descends toward the bigram entropy).
Batches are a pure function of (seed, step, host_id): resuming from a
checkpoint reproduces the exact stream.  ``batch(step)`` returns numpy;
the training loop moves it to the mesh's device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 8       # out-degree of the bigram graph
    host_id: int = 0
    num_hosts: int = 1


class BigramStream:
    """Seeded bigram language; batches indexed by absolute step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        # sparse-ish transition table: each token can be followed by
        # `branching` successors with dirichlet weights
        self.succ = root.integers(0, cfg.vocab,
                                  (cfg.vocab, cfg.branching)).astype(np.int32)
        self.probs = root.dirichlet(np.ones(cfg.branching),
                                    size=cfg.vocab).astype(np.float32)
        assert cfg.global_batch % cfg.num_hosts == 0
        self.host_batch = cfg.global_batch // cfg.num_hosts

    def entropy(self) -> float:
        """Per-token entropy of the generating process (nats) — the loss
        floor the model should approach."""
        h = -(self.probs * np.log(self.probs + 1e-9)).sum(axis=1)
        return float(h.mean())

    def batch(self, step: int) -> dict:
        """{tokens: [host_batch, seq_len + 1]} for this host at `step`."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_id, 0xACE5))
        b, t = self.host_batch, cfg.seq_len + 1
        toks = np.empty((b, t), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, b)
        for i in range(1, t):
            u = rng.random((b, 1))
            cum = np.cumsum(self.probs[toks[:, i - 1]], axis=1)
            choice = (u < cum).argmax(axis=1)
            toks[:, i] = self.succ[toks[:, i - 1], choice]
        return {"tokens": toks}

    def iter_from(self, step: int) -> Iterator[dict]:
        while True:
            yield self.batch(step)
            step += 1


def synthetic_context(step: int, batch: int, tokens: int, d_model: int,
                      seed: int = 0) -> np.ndarray:
    """Stub modality embeddings (whisper frames / vision patches)."""
    rng = np.random.default_rng((seed, step, 0xC0DE))
    return rng.standard_normal((batch, tokens, d_model)).astype(np.float32)
