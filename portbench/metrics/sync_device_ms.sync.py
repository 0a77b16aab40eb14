"""Device time a gradient-sync call, ms: the union of the device
operations' intervals over the profiled calls, over their count."""

def read(record: dict):
    prof = record.get("trace")
    if not prof or "least_bytes" not in record:
        return None
    return 1e3 * prof["busy_s"] / prof["count"]
