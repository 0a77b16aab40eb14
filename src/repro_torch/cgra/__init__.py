"""The switch CGRA: the device model (:mod:`.device`), the mapper that
places stage bodies on it (:mod:`.mapper`, imported by the compiler's
PlaceCGRA pass when it runs) and the dataplane simulator
(:mod:`.simulate`).

Only :mod:`.device` is imported eagerly: :mod:`repro_torch.core.netmodel`
derives its accelerator rates from it, and mapper/simulate pull in the
compiler, so eager imports here would cycle.
"""

from repro_torch.cgra.device import (CGRADevice, HostFallback, PAPER_CGRA,
                                     Placement, placement_rate,
                                     route_through)

__all__ = [
    "CGRADevice", "HostFallback", "PAPER_CGRA", "Placement",
    "placement_rate", "route_through",
    # lazy (PEP 562):
    "PlaceCGRA", "SwitchSim", "SimReport", "SimStage", "FaultPlan",
]

_LAZY = {
    "PlaceCGRA": "repro_torch.core.compiler",
    "SwitchSim": "repro_torch.cgra.simulate",
    "SimReport": "repro_torch.cgra.simulate",
    "SimStage": "repro_torch.cgra.simulate",
    "FaultPlan": "repro_torch.cgra.simulate",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'repro_torch.cgra' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
