"""Device operations launched a gradient-sync call, from the profiled
calls of the traced run."""

def read(record: dict):
    prof = record.get("trace")
    if not prof or "least_bytes" not in record:
        return None
    return prof["ops"] / prof["count"]
