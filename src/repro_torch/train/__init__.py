"""repro_torch.train — loss, optimizers, the acis train step and the
fault-tolerant loop."""
