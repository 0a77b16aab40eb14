"""acis-100m — the ~100M-param dense model of the end-to-end training
example, the vehicle for the paper's gradient-sync collectives.

The port's copy of :mod:`repro.configs.acis_100m` (the dense family's
model path serves it), plus :func:`grad_leaf_specs`: the model's
gradient leaves — one per
parameter — with the shapes and dtypes the reference's
``Model(CONFIG).param_shapes()`` gives them, in the reference's flatten
order.  ``chip_smoke.py`` builds the full-width
gradient pytree from it.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="acis-100m", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
    d_ff=2048, vocab=32000, activation="swiglu", max_seq=2048,
    remat="none",
)

SMOKE = ModelConfig(
    name="acis-100m-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, activation="swiglu", max_seq=128,
    remat="none",
)


def grad_leaf_specs(cfg: ModelConfig = CONFIG
                    ) -> list[tuple[str, tuple[int, ...], torch.dtype]]:
    """``(path, shape, dtype)`` of every gradient leaf of a dense swiglu
    model, in flatten order (dict keys sorted at every level; ``path``
    joins the keys with dots, and a flat dict keyed by it flattens in
    the same order).  Matrices are bf16, norm scales f32; the layer
    stack is one leading ``n_layers`` dim."""
    if cfg.family != "dense" or cfg.activation != "swiglu":
        raise NotImplementedError(
            f"grad_leaf_specs covers dense swiglu models, got {cfg.name}")
    L, d, f, v = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    q = cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    bf16, f32 = torch.bfloat16, torch.float32
    layer = "layers.pos0_self."
    specs = {
        "embed": ((v, d), bf16),
        "final_norm.scale": ((d,), f32),
        layer + "attn.wk": ((L, d, kv), bf16),
        layer + "attn.wo": ((L, q, d), bf16),
        layer + "attn.wq": ((L, d, q), bf16),
        layer + "attn.wv": ((L, d, kv), bf16),
        layer + "ffn.wi_gate": ((L, d, f), bf16),
        layer + "ffn.wi_up": ((L, d, f), bf16),
        layer + "ffn.wo": ((L, f, d), bf16),
        layer + "ln1.scale": ((L, d), f32),
        layer + "ln2.scale": ((L, d), f32),
        "lm_head": ((d, v), bf16),
    }
    return [(k, shape, dt) for k, (shape, dt) in sorted(specs.items())]
