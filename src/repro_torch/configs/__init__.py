"""Model configurations the port carries (its own copies of the reference's).

``get(name)`` returns the full published config and ``get_smoke(name)``
the reduced same-family config of the CPU tests, as
:mod:`repro.configs` does.  The port holds a config once it runs the
model's path: ``rwkv6-1.6b`` and ``recurrentgemma-9b`` (serving) and
``acis-100m`` (its gradient leaves, for the sync paths).  Every other name of the reference's
registry raises ``NotImplementedError`` naming the ROADMAP.md item it
waits for.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# the reference's canonical dashed ids -> the port's modules
PORTED = {
    "rwkv6-1.6b": "rwkv6_1_6b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "acis-100m": "acis_100m",
}

# the reference's other ids -> the ROADMAP.md item that ports their path
WAITING = {name: "queue 1 item 6 (models)" for name in (
    "nemotron-4-15b", "granite-8b", "qwen3-8b", "granite-3-8b",
    "qwen2-moe-a2.7b", "deepseek-v2-236b", "whisper-small",
    "llama-3.2-vision-11b")}


def _module(name: str):
    if name in WAITING:
        raise NotImplementedError(
            f"{name} is not ported yet: it waits for ROADMAP.md "
            f"{WAITING[name]}")
    if name not in PORTED:
        raise KeyError(f"unknown model {name!r}; the port carries "
                       f"{sorted(PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{PORTED[name]}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def names() -> list[str]:
    """The ids the port runs a model path for (``acis-100m`` carries only
    gradient shapes, as the reference's ``names()`` leaves it out)."""
    return [k for k in PORTED if k != "acis-100m"]
