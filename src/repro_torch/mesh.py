"""LocalMesh — every rank of a mesh held in one tensor on one device.

The reference runs each rank as its own JAX device under ``shard_map``,
where a rank-local value has the *local* shape and ``lax.ppermute`` moves
it between devices.  The port keeps all ranks of the mesh in one tensor:
every rank-local value carries the mesh dims in front, ``[data, *local]``
(or ``[pod, data, *local]``), and

  * ``ppermute`` by a cyclic shift becomes a roll along that axis's dim,
  * ``lax.axis_index`` becomes an ``arange`` broadcastable over the rank
    dims, and ``lax.axis_size`` a lookup,
  * ``jit(shard_map(...))`` becomes eager execution inside ``with mesh:``
    — the active mesh is what the ring schedules and compiled programs
    talk to, the way ``lax.axis_size`` reads the enclosing ``shard_map``.

Those three operations are the :class:`Transport` interface, so a
``torch.distributed`` transport (one rank per process) can take the
mesh's place later without touching the schedules.

Outside any ``with mesh:`` block tensors are plain rank-local values (no
rank dims): the pure helpers (codecs, padding) then act on the tensor as
a whole, and the ring schedules raise.
"""

from __future__ import annotations

import contextvars
import math
from typing import Optional, Sequence

import torch

_ACTIVE: contextvars.ContextVar[Optional["Transport"]] = \
    contextvars.ContextVar("repro_torch_transport", default=None)


class PartitionSpec(tuple):
    """How a global tensor's dims map onto mesh axes, one entry per dim
    as in ``shard_map``: ``P("data")`` shards the leading dim over
    ``data``, ``P("pod", "data", None)`` the first dim over ``pod`` and
    the second over ``data``, ``P(("pod", "data"))`` the leading dim over
    both (pod-major); ``P(None)`` / ``P()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"P{tuple(self)!r}"


P = PartitionSpec


class Transport:
    """What a ring schedule needs of the ranks it runs over, plus the
    rank-dim bookkeeping every rank-local function shares.

    ``rank_shape`` is the sizes of the rank dims every rank-local tensor
    carries in front of its local shape (``()`` when there are none).
    """

    rank_shape: tuple[int, ...] = ()
    axis_names: tuple[str, ...] = ()

    # -- the communication interface ----------------------------------------

    def axis_size(self, axis: str) -> int:
        raise NotImplementedError

    def axis_index(self, axis: str) -> torch.Tensor:
        """This rank's index along ``axis``: an integer tensor
        broadcastable over the rank dims."""
        raise NotImplementedError

    def shift(self, x: torch.Tensor, axis: str, k: int) -> torch.Tensor:
        """Cyclic shift by ``k`` along ``axis``: rank ``j`` sends to rank
        ``j + k``, so the result at rank ``r`` is ``x`` of rank ``r - k``
        (``lax.ppermute`` with the ``(j, (j + k) % n)`` permutation)."""
        raise NotImplementedError

    # -- rank-dim bookkeeping ------------------------------------------------

    @property
    def rank_ndim(self) -> int:
        return len(self.rank_shape)

    def local_shape(self, x) -> tuple[int, ...]:
        """The shape one rank holds: ``x``'s shape without the rank dims.
        Every size the compiler reads goes through here."""
        return tuple(x.shape[self.rank_ndim:])

    def local_numel(self, x) -> int:
        return math.prod(self.local_shape(x))

    def flatten_local(self, x: torch.Tensor) -> torch.Tensor:
        """``x.reshape(-1)`` of every rank: ``[*rank, numel]``."""
        return x.reshape(self.rank_shape + (-1,))

    def reshape_local(self, x: torch.Tensor,
                      shape: Sequence[int]) -> torch.Tensor:
        return x.reshape(self.rank_shape + tuple(shape))

    def rank_bcast(self, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """View a per-rank value ``t`` (broadcastable over the rank dims)
        so it broadcasts against ``x`` rank by rank."""
        return t.reshape(tuple(t.shape) + (1,) * (x.dim() - t.dim()))

    def _grids(self, device) -> list[torch.Tensor]:
        nd = self.rank_ndim
        return [torch.arange(s, device=device).reshape(
            [s if j == d else 1 for j in range(nd)])
            for d, s in enumerate(self.rank_shape)]

    def take(self, xs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Per-rank ``xs[idx]`` along the first local dim — rank ``r``
        reads its own chunk ``idx[r]`` (``lax.dynamic_index_in_dim`` of
        every rank at once)."""
        return xs[(*self._grids(xs.device), idx)]

    def put(self, out: torch.Tensor, idx: torch.Tensor,
            val: torch.Tensor) -> None:
        """Per-rank ``out[idx] = val`` along the first local dim, in
        place."""
        out[(*self._grids(out.device), idx)] = val

    # -- activation ------------------------------------------------------------

    def __enter__(self):
        tokens = self.__dict__.setdefault("_tokens", [])
        tokens.append(_ACTIVE.set(self))
        return self

    def __exit__(self, *exc):
        _ACTIVE.reset(self.__dict__["_tokens"].pop())
        return False


class Unranked(Transport):
    """No rank dims and no axes: what code outside any mesh sees, and
    what the compiler evaluates map bodies under to size them (avals are
    local shapes, and — as under ``jax.eval_shape`` — no axis is bound)."""

    def axis_size(self, axis):
        raise RuntimeError(
            f"axis {axis!r} is not bound: run inside `with LocalMesh(...):`")

    axis_index = shift = axis_size


UNRANKED = Unranked()


def current() -> Transport:
    """The active transport; raises outside ``with mesh:``."""
    tp = _ACTIVE.get()
    if tp is None:
        raise RuntimeError(
            "no active mesh: rank-local collectives run inside "
            "`with LocalMesh(...):` (the port's shard_map region)")
    return tp


def ambient() -> Transport:
    """The active transport, or :data:`UNRANKED` outside any mesh."""
    tp = _ACTIVE.get()
    return UNRANKED if tp is None else tp


def default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "asks for the CPU (device='cpu')")
    return torch.device("cuda")


class LocalMesh(Transport):
    """All ranks of a mesh in one tensor: ``LocalMesh({"data": 8})``.

    Axes keep the dict's order, which is the order of the rank dims.
    ``device`` defaults to ``"cuda"`` and raises when no card is present;
    pass ``device="cpu"`` to run on the host (``"meta"`` compiles and
    sizes programs without any data).
    """

    def __init__(self, axes: dict, device=None):
        if not axes:
            raise ValueError("a mesh needs at least one axis")
        self.axes = {str(k): int(v) for k, v in axes.items()}
        if any(v < 1 for v in self.axes.values()):
            raise ValueError(f"axis sizes must be >= 1, got {self.axes}")
        self.device = default_device() if device is None \
            else torch.device(device)
        self.axis_names = tuple(self.axes)
        self.rank_shape = tuple(self.axes.values())
        self._index: dict[str, torch.Tensor] = {}

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"LocalMesh({self.axes}, device={str(self.device)!r})"

    @property
    def n_ranks(self) -> int:
        return math.prod(self.rank_shape)

    @property
    def shape(self) -> dict:
        """``{axis: size}`` in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(self.axes)

    def dim(self, axis: str) -> int:
        try:
            return self.axis_names.index(axis)
        except ValueError:
            raise KeyError(
                f"axis {axis!r} not on mesh {self.axis_names}") from None

    def axis_size(self, axis: str) -> int:
        return self.axes[self.axis_names[self.dim(axis)]]

    def axis_index(self, axis: str) -> torch.Tensor:
        got = self._index.get(axis)
        if got is None:
            d = self.dim(axis)
            got = torch.arange(self.rank_shape[d], device=self.device).reshape(
                [s if j == d else 1 for j, s in enumerate(self.rank_shape)])
            self._index[axis] = got
        return got

    def shift(self, x: torch.Tensor, axis: str, k: int) -> torch.Tensor:
        return torch.roll(x, k, dims=self.dim(axis))

    # -- global tensors <-> rank-stacked tensors (shard_map's in/out specs) --

    def _spec_dims(self, spec, ndim: int) -> list[tuple[str, ...]]:
        """The mesh axes each of a global tensor's ``ndim`` dims is split
        over, major first; raises on an axis used twice or not on the
        mesh."""
        entries = tuple(spec) if spec is not None else ()
        while len(entries) > ndim and entries[-1] is None:
            entries = entries[:-1]          # P(None) of a scalar
        if len(entries) > ndim:
            raise ValueError(f"partition spec {spec!r} has more entries "
                             f"than the tensor's {ndim} dims")
        dims, seen = [], set()
        for e in entries + (None,) * (ndim - len(entries)):
            axes = () if e is None else (e,) if isinstance(e, str) \
                else tuple(e)
            for a in axes:
                self.dim(a)                         # raises if absent
                if a in seen:
                    raise ValueError(f"axis {a!r} used twice in {spec!r}")
                seen.add(a)
            dims.append(axes)
        return dims

    def shard(self, x: torch.Tensor, spec) -> torch.Tensor:
        """A global tensor → the rank-stacked tensor ``shard_map`` would
        hand the ranks under ``spec``: every sharded dim is split over its
        axes (major first), and the ranks of the axes ``spec`` leaves out
        hold copies.  ``[*rank_shape, *local]``, contiguous, on this
        mesh's device."""
        x = torch.as_tensor(x, device=self.device)
        shape, pos = [], {}
        for j, axes in enumerate(self._spec_dims(spec, x.dim())):
            n = math.prod(self.axis_size(a) for a in axes)
            if x.shape[j] % n:
                raise ValueError(f"dim {j} of size {x.shape[j]} not "
                                 f"divisible by the {n} ranks of {axes}")
            for a in axes:
                pos[a] = len(shape)
                shape.append(self.axis_size(a))
            shape.append(x.shape[j] // n)
        local = [k for k in range(len(shape)) if k not in pos.values()]
        for a in self.axis_names:             # replicated: a size-1 dim
            if a not in pos:
                pos[a] = len(shape)
                shape.append(1)
        y = x.reshape(shape).permute(
            [pos[a] for a in self.axis_names] + local)
        return y.expand(self.rank_shape + tuple(y.shape[self.rank_ndim:])) \
            .contiguous()

    def unshard(self, y: torch.Tensor, spec) -> torch.Tensor:
        """The inverse of :meth:`shard`: every sharded dim gathered from
        its axes' ranks (major first), rank 0's copy along the axes
        ``spec`` leaves out."""
        nd = self.rank_ndim
        dims = self._spec_dims(spec, y.dim() - nd)
        used = [a for axes in dims for a in axes]
        y = y[tuple(slice(None) if a in used else 0
                    for a in self.axis_names)]
        kept = [a for a in self.axis_names if a in used]
        perm, shape = [], []
        for j, axes in enumerate(dims):
            perm += [kept.index(a) for a in axes] + [len(kept) + j]
            shape.append(y.shape[len(kept) + j]
                         * math.prod(self.axis_size(a) for a in axes))
        return y.permute(perm).reshape(shape)
