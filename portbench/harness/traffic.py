"""The benchmark's one traffic generator: batches for training, made on
the device from the seed.

Tokens come from a seeded bigram language, a copy of the port's
``BigramStream`` idea (every token has ``branching`` successors with
Dirichlet(1) weights, so the stream has learnable structure) drawn with
``torch`` on the device instead of numpy on the host.  An encoder-decoder
configuration also gets a stub context a row: standard-normal frame
embeddings ``[encoder_seq, d_model]`` in bfloat16, the port's
``synthetic_context`` made on the device.  Every row of the pool is drawn
afresh, so rows differ.
"""

from __future__ import annotations

import torch

from portbench.harness.seeds import generator


def bigram_tokens(vocab: int, rows: int, length: int, seed: int, device,
                  branching: int = 8) -> torch.Tensor:
    """[rows, length] int64 token ids of the seed's bigram language."""
    g = generator(device, seed, "bigram")
    succ = torch.randint(0, vocab, (vocab, branching), generator=g,
                         device=device)
    e = -torch.log(torch.rand((vocab, branching), generator=g,
                              device=device).clamp_min(1e-30))
    cum = (e / e.sum(1, keepdim=True)).cumsum(1)
    u = torch.rand((rows, length - 1, 1), generator=g, device=device)
    toks = torch.empty((rows, length), dtype=torch.int64, device=device)
    toks[:, 0] = torch.randint(0, vocab, (rows,), generator=g,
                               device=device)
    for i in range(1, length):
        prev = toks[:, i - 1]
        choice = (u[:, i - 1] < cum[prev]).to(torch.int8).argmax(1)
        toks[:, i] = succ[prev, choice]
    return toks


def train_pool(cfg: dict, job: dict, seed: int, device) -> list[dict]:
    """``job["pool"]`` global batches ``{"tokens": [B, seq + 1],
    "context": [B, Te, d] or None}``, B = ranks x rows a rank."""
    batch = job["ranks"] * job["rows_per_rank"]
    n = job["pool"]
    toks = bigram_tokens(cfg["vocab"], n * batch, job["seq"] + 1, seed,
                         device, job["branching"])
    ctx = None
    if cfg["family"] == "encdec":
        te = cfg["encdec"]["encoder_seq"]
        ctx = torch.randn((n * batch, te, cfg["d_model"]),
                          generator=generator(device, seed, "context"),
                          dtype=torch.bfloat16, device=device)
    return [{"tokens": toks[i * batch:(i + 1) * batch],
             "context": None if ctx is None
             else ctx[i * batch:(i + 1) * batch]} for i in range(n)]
