"""Device ms a training step in the port's ``acis.moe.route`` (router,
top-k, sort, gather) and ``acis.moe.combine`` (the weighted scatter
back) spans: the forward and the recomputed forward of the remat (the
backward's launches belong to ``acis.train.backward``), from the traced
run's second profiled pass (``harness/program.py``)."""

from portbench.harness.program import TRAIN_ROOT, device_ms

SPANS = ("acis.moe.route", "acis.moe.combine")


def read(record: dict):
    return device_ms(record, TRAIN_ROOT, lambda names: any(
        n in SPANS for n in names))
