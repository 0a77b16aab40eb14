"""The gradient sync's share of its roofline, %: the least bytes a mean
all-reduce of the cell's tree must move on one card (every rank's
gradient read once and its result written once, plus a residual read
and written once where the sync keeps one; ``harness/counts.py``) at the
card's published HBM bandwidth, over the device time of a call
(``sync_device_ms.sync``)."""

from portbench.harness import counts


def read(record: dict):
    prof = record.get("trace")
    if not prof or "least_bytes" not in record or prof["busy_s"] <= 0:
        return None
    try:
        _, bw = counts.peaks(record["device_kind"])
    except KeyError:
        return None
    bound_s = record["least_bytes"] / bw
    return 100.0 * bound_s / (prof["busy_s"] / prof["count"])
