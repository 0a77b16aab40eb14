"""repro_torch.checkpoint — atomic checkpoints in the reference's
on-disk layout."""
