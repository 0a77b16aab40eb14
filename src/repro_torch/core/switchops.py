"""SPU instruction registry — the per-hop vector op set of the "CGRA".

The PyTorch counterpart of :mod:`repro.core.switchops`.  Every op has a
plain PyTorch implementation, and the compute-hot ones carry a
hand-written CUDA kernel (see :mod:`repro_torch.kernels`) selected by
``use_kernel=True``.  Collectives look combines up here, so adding a user
op (Type 2) is one ``register()`` call — the analogue of loading a new
CGRA binary into the switch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class SwitchOp:
    name: str
    ref: Callable          # plain PyTorch version (always available)
    kernel: Optional[Callable] = None  # hand-written kernel wrapper

    def __call__(self, *args, use_kernel: bool = False, **kw):
        impl = self.kernel if (use_kernel and self.kernel is not None) \
            else self.ref
        return impl(*args, **kw)


_REGISTRY: Dict[str, SwitchOp] = {}


def register(name: str, ref: Callable,
             kernel: Optional[Callable] = None) -> SwitchOp:
    op = SwitchOp(name, ref, kernel)
    _REGISTRY[name] = op
    return op


def get(name: str) -> SwitchOp:
    return _REGISTRY[name]


def names() -> list[str]:
    return sorted(_REGISTRY)


def attach_kernel(name: str, kernel: Callable) -> None:
    """Late-bind a kernel to an existing op (the kernel modules import
    lazily, so the registry never loads them at import time)."""
    old = _REGISTRY[name]
    _REGISTRY[name] = SwitchOp(old.name, old.ref, kernel)


def _ref(name: str) -> Callable:
    def call(*args, **kw):
        from repro_torch.kernels import ref

        return getattr(ref, name)(*args, **kw)
    return call


# -- the base instruction set -------------------------------------------------

register("add", lambda a, b: a + b)
register("max", torch.maximum)
register("min", torch.minimum)
register("mac", _ref("combine_mac"))
register("dot_accumulate", lambda acc, a, b: acc + a @ b)
register("prefix_sum", lambda x: torch.cumsum(x, dim=0))
register("relu2", lambda x: torch.square(torch.clamp_min(x, 0)))
register("topk_accumulate", _ref("topk_accumulate"))
register("pack_combine", _ref("pack_combine"))


def load_kernels() -> None:
    """Bind the ported kernels onto the registry (idempotent).  The
    ``prefix_sum`` and ``topk_accumulate`` kernels are not ported yet and
    keep their plain versions."""
    from repro_torch.kernels import ops as kops

    attach_kernel("add", kops.combine_add)
    attach_kernel("max", kops.combine_max)
    attach_kernel("min", kops.combine_min)
    attach_kernel("mac", kops.combine_mac)
    attach_kernel("pack_combine", kops.pack_combine)
