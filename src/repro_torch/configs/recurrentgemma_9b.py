"""recurrentgemma-9b — hybrid RG-LRU + local attention, pattern (R,R,A).
[arXiv:2402.19427; unverified]  38 = 12 x (lru,lru,attn) + (lru,lru).
Sub-quadratic (window 2048 + O(1) recurrent state) => long_500k eligible."""

from repro_torch.models.config import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, activation="geglu",
    max_seq=32768, subquadratic=True,
    hybrid=HybridConfig(pattern=("lru", "lru", "attn"), window=2048,
                        lru_width=4096, conv_width=4),
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=512, activation="geglu", max_seq=256,
    subquadratic=True,
    hybrid=HybridConfig(pattern=("lru", "lru", "attn"), window=16,
                        lru_width=64, conv_width=4),
    remat="none",
)
