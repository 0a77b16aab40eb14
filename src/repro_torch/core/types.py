"""Core taxonomy types for ACiS (Advanced Computing in the Switch).

The PyTorch counterpart of :mod:`repro.core.types`: the taxonomy levels
(:class:`AcisType`) and :class:`Monoid` — a combine with identity, the
algebraic object a reduction/scan collective is parameterized by.  Type 1
uses the fixed builtin monoids; Type 2 permits arbitrary user monoids over
arbitrary pytree "wire dtypes".  Combines act elementwise, so they apply
unchanged to rank-stacked tensors (``[*rank, *local]``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import tree

PyTree = Any


class AcisType(enum.IntEnum):
    """The ACiS taxonomy (paper Table I)."""

    STREAM = 0        # stream transforms (dtype change, checksum)
    COLLECTIVE = 1    # collectives on primitive types, fixed ops
    USER_DEFINED = 2  # user-defined ops / dtypes / communicators
    LOOK_ASIDE = 3    # state + loops + off-chip (HBM) memory
    FUSED = 4         # fused collectives and map functions


class TensorSpec(NamedTuple):
    """Shape, dtype and device of a tensor that does not exist yet (the
    port's ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype
    device: Optional[torch.device] = None


@dataclasses.dataclass(frozen=True)
class Monoid:
    """An associative combine with identity.

    ``combine`` must be associative (commutative too for reduction
    collectives whose hop order is rank-dependent).  ``identity`` takes
    anything with ``shape``/``dtype`` (and optionally ``device``) — a
    :class:`TensorSpec` or a tensor — and returns the identity element of
    that shape.
    """

    name: str
    combine: Callable[[PyTree, PyTree], PyTree]
    identity: Callable[[Any], PyTree]
    commutative: bool = True

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Monoid({self.name})"


def _full(x: Any, val) -> torch.Tensor:
    return torch.full(tuple(x.shape), val, dtype=x.dtype,
                      device=getattr(x, "device", None))


def _lowest(dtype: torch.dtype):
    return torch.finfo(dtype).min if dtype.is_floating_point \
        else torch.iinfo(dtype).min


def _highest(dtype: torch.dtype):
    return torch.finfo(dtype).max if dtype.is_floating_point \
        else torch.iinfo(dtype).max


# PyTorch has no arithmetic on fp8 tensors; XLA computes it in f32 and
# rounds the result once, so the combines do the same
_FP8 = {torch.float8_e4m3fn, torch.float8_e5m2}


def _widening(op: Callable) -> Callable:
    def combine(a, b):
        if a.dtype in _FP8:
            return op(a.to(torch.float32), b.to(torch.float32)).to(a.dtype)
        return op(a, b)
    return combine


# ---------------------------------------------------------------------------
# Type 1 fixed monoids (the BlueGene/SHArP-class op set).
# ---------------------------------------------------------------------------

ADD = Monoid("add", _widening(torch.add), lambda x: _full(x, 0))
MAX = Monoid("max", _widening(torch.maximum),
             lambda x: _full(x, _lowest(x.dtype)))
MIN = Monoid("min", _widening(torch.minimum),
             lambda x: _full(x, _highest(x.dtype)))
PROD = Monoid("prod", _widening(torch.mul), lambda x: _full(x, 1))

TYPE1_MONOIDS = {m.name: m for m in (ADD, MAX, MIN, PROD)}


def tree_monoid(leaf_monoid: Monoid) -> Monoid:
    """Lift a leaf monoid to pytrees (Type 2 'user-defined datatypes')."""

    def combine(a: PyTree, b: PyTree) -> PyTree:
        return tree.tree_map(leaf_monoid.combine, a, b)

    def identity(struct: PyTree) -> PyTree:
        return tree.tree_map(leaf_monoid.identity, struct)

    return Monoid(f"tree_{leaf_monoid.name}", combine, identity,
                  leaf_monoid.commutative)


# ---------------------------------------------------------------------------
# Example Type 2 user-defined monoids (paper §II: "e.g. dot product",
# sparse/matrix datatypes) — data points showing the engine is op/dtype
# polymorphic; users supply their own.
# ---------------------------------------------------------------------------


def _argmax_combine(a, b):
    """(value, payload) argmax-with-payload: keeps payload of the max."""
    av, ap = a
    bv, bp = b
    take_a = av >= bv
    return torch.where(take_a, av, bv), torch.where(take_a, ap, bp)


ARGMAX_WITH_PAYLOAD = Monoid(
    "argmax_payload",
    _argmax_combine,
    lambda s: (_full(s[0], float("-inf")), _full(s[1], 0)),
)


def _welford_combine(a, b):
    """Parallel Welford mean/variance merge — a stateful 'matrix-like' dtype."""
    na, ma, sa = a
    nb, mb, sb = b
    n = na + nb
    safe_n = torch.where(n > 0, n, torch.ones_like(n))
    delta = mb - ma
    m = ma + delta * (nb / safe_n)
    s = sa + sb + delta * delta * (na * nb / safe_n)
    return n, m, s


WELFORD = Monoid(
    "welford",
    _welford_combine,
    lambda s: (_full(s[0], 0), _full(s[1], 0), _full(s[2], 0)),
)
