"""Device operations (kernels, copies, sets) launched a training
step, from the profiled steps of the traced run."""

def read(record: dict):
    prof = record.get("trace")
    if not prof or "step_flops" not in record:
        return None
    return prof["ops"] / prof["count"]
