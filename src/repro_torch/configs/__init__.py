"""Model configurations the port carries (its own copies of the reference's).

``get(name)`` returns the full published config and ``get_smoke(name)``
the reduced same-family config of the CPU tests, as
:mod:`repro.configs` does.  The port holds every config of the
reference's registry, and runs each model's path: the ten assigned
architectures and ``acis-100m`` (the paper's example model, whose
gradient leaves the sync paths use).  Names resolve as the reference
resolves them: a canonical dashed id, or its module name with ``-`` and
``.`` spelled ``_`` (``qwen2-moe-a2-7b`` is ``qwen2-moe-a2.7b``); any
other name raises ``KeyError``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# the reference's canonical dashed ids -> the port's modules
PORTED = {
    "nemotron-4-15b": "nemotron_4_15b",
    "granite-8b": "granite_8b",
    "qwen3-8b": "qwen3_8b",
    "granite-3-8b": "granite_3_8b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "whisper-small": "whisper_small",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "acis-100m": "acis_100m",
}


def _canonical(name: str) -> str:
    """The dashed id of ``name`` (a dashed id or its module spelling)."""
    key = name.replace("-", "_").replace(".", "_")
    for known in PORTED:
        if known.replace("-", "_").replace(".", "_") == key:
            return known
    return name


def _module(name: str):
    name = _canonical(name)
    if name not in PORTED:
        raise KeyError(f"unknown model {name!r}; the port carries "
                       f"{sorted(PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{PORTED[name]}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


def names() -> list[str]:
    """The reference's ``names()``: every id but ``acis-100m``, in the
    reference's order."""
    return [k for k in PORTED if k != "acis-100m"]
