"""repro_torch.data — the deterministic synthetic data pipeline."""
