"""Device ms a training step in the port's ``acis.moe.experts`` span
(the held experts' grouped products and the shared experts: the forward
and the recomputed forward of the remat; the backward's launches belong
to ``acis.train.backward``), from the traced run's second profiled pass
(``harness/program.py``)."""

from portbench.harness.program import TRAIN_ROOT, _in, device_ms


def read(record: dict):
    return device_ms(record, TRAIN_ROOT, _in("acis.moe.experts"))
