"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]  O(1) decode state => long_500k eligible."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536, activation="relu2",
    max_seq=32768, subquadratic=True,
)

SMOKE = ModelConfig(
    name="rwkv6-1.6b-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
    d_ff=256, vocab=512, activation="relu2", max_seq=256,
    subquadratic=True, remat="none",
)
