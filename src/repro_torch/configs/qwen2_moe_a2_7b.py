"""qwen2-moe-a2.7b — MoE: 60 routed top-4 + 4 shared (MHA kv=16).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

The port's copy of :mod:`repro.configs.qwen2_moe_a2_7b` (CONFIG and SMOKE field
for field)."""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, activation="swiglu",
    max_seq=32768,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4,
                  d_ff_expert=1408, d_ff_shared=5632),
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=512, activation="swiglu", max_seq=256,
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=1,
                  d_ff_expert=96, d_ff_shared=128, capacity_factor=4.0),
    remat="none",
)
