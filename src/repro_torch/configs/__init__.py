"""Model configurations the port carries (its own copies of the reference's).

``get(name)`` returns the full published config and ``get_smoke(name)``
the reduced same-family config of the CPU tests, as
:mod:`repro.configs` does.  The port holds a config once it runs the
model's path: the dense models (``acis-100m`` — its model path and its
gradient leaves, for the sync paths — ``granite-8b``, ``granite-3-8b``,
``qwen3-8b``, ``nemotron-4-15b``), the GQA MoE ``qwen2-moe-a2.7b``,
``rwkv6-1.6b`` and ``recurrentgemma-9b`` (serving).  Every other name of
the reference's registry raises ``NotImplementedError`` naming the
ROADMAP.md item it waits for.  Names resolve as the reference resolves
them: a canonical dashed id, or its module name with ``-`` and ``.``
spelled ``_`` (``qwen2-moe-a2-7b`` is ``qwen2-moe-a2.7b``).
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
    "rwkv6-1.6b": "rwkv6_1_6b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "acis-100m": "acis_100m",
}

# the reference's other ids -> the ROADMAP.md item that ports their path
WAITING = {
    "deepseek-v2-236b": "queue 1 item 6 (models: MLA attention)",
    "whisper-small": "queue 1 item 6 (models: the encdec family)",
    "llama-3.2-vision-11b": "queue 1 item 6 (models: the vlm family)",
}


def _canonical(name: str) -> str:
    """The dashed id of ``name`` (a dashed id or its module spelling)."""
    key = name.replace("-", "_").replace(".", "_")
    for known in (*PORTED, *WAITING):
        if known.replace("-", "_").replace(".", "_") == key:
            return known
    return name


def _module(name: str):
    name = _canonical(name)
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
    """The ids of the reference's ``names()`` the port runs a model path
    for (``acis-100m`` is left out, as there)."""
    return [k for k in PORTED if k != "acis-100m"]
