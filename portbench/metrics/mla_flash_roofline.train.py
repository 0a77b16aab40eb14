"""The fused attention kernels' share of the card's dense bf16 peak at
latent attention's per-head widths (keys 192, values 128), %: the
operations the port counts under ``kernel.attention.flops`` (the
attention's own, from each call's shapes: ``2 (d_qk + d_v)`` a visible
pair and head forward, ``2 (3 d_qk + 2 d_v)`` backward) over the device
time of the kernels instantiated at (192, 128), in the traced run's
second profiled pass, at the published peak (989 TFLOP/s on the
H100)."""

from portbench.harness import counts

WIDE = "<192, 128>"


def read(record: dict):
    prog = record.get("program")
    if not prog or not prog["counters"].get("kernel.attention.flops"):
        return None
    busy_us = sum(t - s for s, t, name, _ in prog["ops"] if WIDE in name)
    if busy_us <= 0:
        return None
    try:
        peak, _ = counts.peaks(record["device_kind"])
    except KeyError:
        return None
    return 100.0 * prog["counters"]["kernel.attention.flops"] / peak \
        / (busy_us / 1e6)
