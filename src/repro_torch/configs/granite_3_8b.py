"""granite-3-8b — dense GQA, 40 layers.
[hf:ibm-granite/granite-3.0-2b-base (family); hf]

The port's copy of :mod:`repro.configs.granite_3_8b` (CONFIG and SMOKE field
for field)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab=49155, activation="swiglu",
    rope_theta=10000.0, max_seq=32768,
)

SMOKE = ModelConfig(
    name="granite-3-8b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=192, vocab=515, activation="swiglu", max_seq=256,
    remat="none",
)
