"""nemotron-4-15b — dense, GQA(kv=8), squared-ReLU FFN, 256k vocab.
[arXiv:2402.16819; unverified]

The port's copy of :mod:`repro.configs.nemotron_4_15b` (CONFIG and SMOKE field
for field)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=24576, vocab=256000, activation="relu2",
    rope_theta=10000.0, max_seq=32768,
)

SMOKE = ModelConfig(
    name="nemotron-4-15b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab=512, activation="relu2", max_seq=256,
    scan_layers=True, remat="none",
)
