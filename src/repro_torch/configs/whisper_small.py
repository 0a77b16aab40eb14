"""whisper-small — encoder-decoder; the conv frontend is a stub (the
context is precomputed frame embeddings [B, 1500, 768]).
[arXiv:2212.04356; unverified]

The port's copy of :mod:`repro.configs.whisper_small` (CONFIG and SMOKE
field for field)."""

from repro_torch.models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, activation="gelu", norm="layer",
    max_seq=32768,   # the reference's decode shapes exceed whisper's 448
    encdec=EncDecConfig(n_encoder_layers=12, encoder_seq=1500),
)

SMOKE = ModelConfig(
    name="whisper-small-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, activation="gelu", norm="layer", max_seq=256,
    encdec=EncDecConfig(n_encoder_layers=2, encoder_seq=16),
    remat="none",
)
