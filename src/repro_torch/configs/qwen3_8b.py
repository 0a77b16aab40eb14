"""qwen3-8b — dense GQA with qk-norm, head_dim 128.
[hf:Qwen/Qwen3-8B; hf]

The port's copy of :mod:`repro.configs.qwen3_8b` (CONFIG and SMOKE field
for field)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_head=128, d_ff=12288, vocab=151936, activation="swiglu",
    qk_norm=True, rope_theta=1000000.0, max_seq=32768,
)

SMOKE = ModelConfig(
    name="qwen3-8b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_head=32,
    d_ff=192, vocab=512, activation="swiglu", qk_norm=True, max_seq=256,
    remat="none",
)
