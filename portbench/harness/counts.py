"""Operations and bytes from shapes, and the card's published peaks.

Model FLOPs count the products a step needs, not what the program runs:
2 per multiply-add of every projection, FFN and logits product, and of
attention's scores and weighted sum (causal self attention counts the
``T(T+1)/2`` pairs it needs); a training step is 3 forwards (forward,
backward), recomputation not counted.  The least bytes of a mean
all-reduce on one card are every rank's input read once and every
rank's result written once (plus an error-feedback residual read and
written once a rank, where the sync keeps one), whatever implements it.
"""

from __future__ import annotations

import math

from portbench.reference.spec import head_dim, param_spec

# NVIDIA's data sheets, dense rates: (name part, bf16 FLOP/s, HBM B/s);
# the first match wins.  The H100 SXM's rates assume its 700 W limit.
PEAKS = (
    ("H100 PCIe", 756e12, 2.0e12),
    ("H100", 989e12, 3.35e12),
)


def peaks(device_name: str) -> tuple[float, float]:
    """``(bf16 FLOP/s, bytes/s)`` of the card called ``device_name``."""
    for part, flops, bw in PEAKS:
        if part in device_name:
            return flops, bw
    raise KeyError(f"no published peaks for {device_name!r}")


def _pairs(tq: int, tk: int, causal: bool) -> int:
    return tq * (tq + 1) // 2 if causal else tq * tk


def forward_flops(cfg: dict, seq: int) -> int:
    """FLOPs of one row's forward over ``seq`` input tokens."""
    d, f, v, n = cfg["d_model"], cfg["d_ff"], cfg["vocab"], cfg["n_layers"]
    q = cfg["n_heads"] * head_dim(cfg)
    kv = cfg["n_kv_heads"] * head_dim(cfg)
    proj = d * q + 2 * d * kv + q * d
    mlp = (3 if cfg["activation"] in ("swiglu", "geglu") else 2) * d * f
    flops = 2 * seq * (n * (proj + mlp) + d * v) \
        + n * 4 * _pairs(seq, seq, True) * q
    if cfg["family"] == "dense":
        return flops
    if cfg["family"] == "encdec":
        te = cfg["encdec"]["encoder_seq"]
        ne = cfg["encdec"]["n_encoder_layers"]
        flops += 2 * te * ne * (proj + mlp) + ne * 4 * _pairs(te, te,
                                                             False) * q
        # cross attention: queries and output from the decoder's tokens,
        # keys and values from the encoder's output
        flops += 2 * seq * n * (d * q + q * d) + 2 * te * n * 2 * d * kv \
            + n * 4 * _pairs(seq, te, False) * q
        return flops
    raise ValueError(f"no FLOP count for family {cfg['family']!r}")


def train_step_flops(cfg: dict, rows: int, seq: int) -> int:
    return 3 * rows * forward_flops(cfg, seq)


def sync_least_bytes(cfg: dict, ranks: int, residual: bool = False) -> int:
    spec = param_spec(cfg)
    tree = sum(math.prod(x.shape) * x.dtype.itemsize for x in spec)
    out = 2 * ranks * tree
    if residual:
        out += 2 * ranks * 4 * sum(math.prod(x.shape) for x in spec)
    return out
