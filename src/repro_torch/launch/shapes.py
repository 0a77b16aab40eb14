"""The assigned input-shape cells and their applicability matrix.

The port of :mod:`repro.launch.shapes`.  LM transformer shapes
(seq_len × global_batch):

    train_4k      4,096 × 256    — training        (the train step)
    prefill_32k  32,768 × 32     — inference prefill
    decode_32k   32,768 × 128    — one-token decode w/ 32k KV cache
    long_500k   524,288 × 1      — long-context decode (sub-quadratic only)

``long_500k`` requires sub-quadratic attention: it runs for
recurrentgemma-9b (local window + RG-LRU) and rwkv6-1.6b (O(1) state)
and is SKIP(full-attention) for the 8 dense-attention archs.
"""

from __future__ import annotations

import dataclasses

from repro_torch import configs


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def applicable(arch: str, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    cfg = configs.get(arch)
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "SKIP(full-attention)"
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in configs.names() for s in SHAPES]


def runnable_cells() -> list[tuple[str, str]]:
    return [(a, s) for a, s in all_cells() if applicable(a, s)[0]]
