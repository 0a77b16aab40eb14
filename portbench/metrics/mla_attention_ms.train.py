"""Device ms a training step in the port's ``acis.mla.*`` spans (the
latent attention block, from its projections to ``wo``: the forward and
the recomputed forward of the remat; the backward's launches belong to
``acis.train.backward``), from the traced run's second profiled pass
(``harness/program.py``)."""

from portbench.harness.program import TRAIN_ROOT, device_ms


def read(record: dict):
    return device_ms(record, TRAIN_ROOT, lambda names: any(
        n.startswith("acis.mla.") for n in names))
