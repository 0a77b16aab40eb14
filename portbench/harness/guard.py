"""The import guard: no run may load the JAX package or JAX itself.

Names are compared whole, by the part before the first dot, so the
port (``repro_torch``) does not match the JAX package (``repro``)."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "repro"))


def loaded_forbidden(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
