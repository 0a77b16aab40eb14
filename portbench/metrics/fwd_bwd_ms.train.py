"""Device time of a training step's forward and backward
(``local_grads``: every rank's gradients), ms: the mean over the traced
run's window steps of the CUDA-event interval around it (idle gaps the
host leaves inside it included)."""

def read(record: dict):
    spans = record["window"].get("fwd_bwd_ms")
    return sum(spans) / len(spans) if spans else None
