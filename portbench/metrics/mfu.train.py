"""Model FLOPs utilization of the whole training step, %: the step's
model FLOPs (``harness/counts.py``, from the shapes, recomputation not
counted) times the steps of the traced run's window (not profiled) over
its host-clock seconds, over the card's published dense bf16 peak."""

from portbench.harness import counts


def read(record: dict):
    win = record["window"]
    if "step_flops" not in record or not win.get("steps"):
        return None
    try:
        peak, _ = counts.peaks(record["device_kind"])
    except KeyError:
        return None
    rate = record["step_flops"] * win["steps"] / win["seconds"]
    return 100.0 * rate / peak
