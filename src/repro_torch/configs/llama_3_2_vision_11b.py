"""llama-3.2-vision-11b — dense GQA backbone with gated cross-attention
image layers every 5th layer; the vision frontend is a stub (the context
is precomputed patch embeddings [B, 1601, 4096]).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The port's copy of :mod:`repro.configs.llama_3_2_vision_11b` (CONFIG and
SMOKE field for field)."""

from repro_torch.models.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, activation="swiglu",
    rope_theta=500000.0, max_seq=32768,
    vlm=VLMConfig(cross_every=5, image_tokens=1601),
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-11b-smoke", family="vlm",
    n_layers=4, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=192, vocab=512, activation="swiglu", max_seq=256,
    vlm=VLMConfig(cross_every=2, image_tokens=16),
    remat="none",
)
