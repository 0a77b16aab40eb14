"""Device time of a training step's gradient sync and AdamW update
(``sync_and_update``), ms: the mean over the traced run's window steps
of the CUDA-event interval around it."""

def read(record: dict):
    spans = record["window"].get("sync_update_ms")
    return sum(spans) / len(spans) if spans else None
