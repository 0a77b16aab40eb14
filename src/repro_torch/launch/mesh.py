"""Production and host meshes.

The port of :mod:`repro.launch.mesh`.  The production meshes are
:class:`~repro_torch.mesh.LocalMesh` es on the ``meta`` device: the dry
run builds every cell's program on them and counts its work without
allocating a byte.  The host mesh holds real tensors, on the card unless
the caller asks for the CPU.
"""

from __future__ import annotations

from repro_torch.mesh import LocalMesh


def make_production_mesh(*, multi_pod: bool = False) -> LocalMesh:
    """16×16 single-pod (256 ranks) or 2×16×16 multi-pod (512 ranks), on
    the meta device."""
    axes = {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}
    return LocalMesh(axes, device="meta")


def make_host_mesh(data: int = 2, model: int = 4, *,
                   device=None) -> LocalMesh:
    """A small ``{"data", "model"}`` mesh (tests, examples): on the card
    by default, ``device="cpu"`` for the host."""
    return LocalMesh({"data": data, "model": model}, device=device)
