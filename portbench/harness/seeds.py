"""Seeds of the benchmark's random streams, derived from ``--seed``.

Each stream (weights, data, gradients) gets its own 63-bit seed from a
hash of the run's seed and the stream's name, so any whole number is a
valid ``--seed`` and one stream never shifts another."""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, *what) -> int:
    key = ":".join(str(x) for x in (seed,) + what).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") \
        & (2 ** 63 - 1)


def generator(device, seed: int, *what) -> torch.Generator:
    """A generator on ``device`` for the stream ``what`` of ``seed``."""
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *what))
