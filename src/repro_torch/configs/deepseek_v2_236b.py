"""deepseek-v2-236b — MLA (kv_lora 512) + MoE 160 routed top-6, 2 shared.
[arXiv:2405.04434; hf]  Optimizer: adafactor.

The port's copy of :mod:`repro.configs.deepseek_v2_236b` (CONFIG and SMOKE
field for field).  About 472 GB in bf16: the card runs it at full width
with fewer layers (``chip_smoke.py``), the CPU tests on the meta device."""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400, activation="swiglu",
    max_seq=32768, optimizer="adafactor",
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2,
                  d_ff_expert=1536, d_ff_shared=3072,
                  first_dense_layers=1, d_ff_dense=12288),
    mla=MLAConfig(kv_lora=512, q_lora=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
)

SMOKE = ModelConfig(
    name="deepseek-v2-236b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=512, activation="swiglu", max_seq=256,
    optimizer="adafactor",
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=1,
                  d_ff_expert=64, d_ff_shared=64,
                  first_dense_layers=1, d_ff_dense=128,
                  capacity_factor=4.0),
    mla=MLAConfig(kv_lora=32, q_lora=48, rope_head_dim=8,
                  nope_head_dim=16, v_head_dim=16),
    remat="none",
)
