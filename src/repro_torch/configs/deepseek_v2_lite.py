"""deepseek-v2-lite — MLA (kv_lora 512, no query compression) with YaRN
rope scaling, a dense first layer, then MoE layers of 64 routed experts
(top-6, softmax scores kept as they are) and 2 shared.
[arXiv:2405.04434; https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite]

The port's own configuration (the reference has no DeepSeek-V2-Lite): it
trains through the port's dropless expert path with DeepSeek-V2's
sequence-level balance loss (``aux_loss_alpha`` 0.001).  CONFIG is the
model as published, every expert held; the benchmark trains a chip's
share of it (``portbench/configs/deepseek-v2-lite.json``).  SMOKE is the
same family at CPU sizes, with every option of CONFIG."""

from repro_torch.models.config import (MLAConfig, ModelConfig, MoEConfig,
                                       YarnConfig)

YARN = YarnConfig(factor=40.0, original_max=4096, beta_fast=32.0,
                  beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707)

CONFIG = ModelConfig(
    name="deepseek-v2-lite", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab=102400, activation="swiglu", max_seq=4096,
    norm_eps=1e-6, rope_theta=10000.0,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2,
                  d_ff_expert=1408, d_ff_shared=2816,
                  first_dense_layers=1, router_aux_weight=0.001,
                  norm_topk_prob=False, routed_scaling_factor=1.0,
                  dropless=True, seq_aux=True),
    mla=MLAConfig(kv_lora=512, q_lora=0, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128, yarn=YARN),
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=512, activation="swiglu", max_seq=64,
    moe=MoEConfig(n_experts=16, top_k=3, n_shared=2,
                  d_ff_expert=32, d_ff_shared=64,
                  first_dense_layers=1, router_aux_weight=0.001,
                  norm_topk_prob=False, routed_scaling_factor=1.0,
                  dropless=True, seq_aux=True),
    mla=MLAConfig(kv_lora=32, q_lora=0, rope_head_dim=8,
                  nope_head_dim=16, v_head_dim=16,
                  yarn=YarnConfig(factor=40.0, original_max=64,
                                  beta_fast=32.0, beta_slow=1.0,
                                  mscale=0.707, mscale_all_dim=0.707)),
    remat="none",
)
