"""Faults a cell can have, planted in the program's timed path, and the
control put in the program's place: what the limits' upper readings are
read from (``calibrate.py``, on the card at the cell's size) and what
the CPU tests see fail.

``planted(name)`` patches the port's module attributes that the window
drivers look up at set-up, and restores them on exit:

  * training (``build_train_step_acis`` or ``local_grads`` wrapped):
    ``unchanged``, the step returns its state unchanged; ``half_batch``,
    each rank's second half of rows left out, the mean over the rest;
    ``no_exchange``, the sync returns every rank's own gradient;
    ``one_rank``, rank 0's rows replaced by rank 1's where the gradients
    are produced;
  * a gradient sync (the engine's ``gradient_sync`` wrapped):
    ``no_exchange``; ``half_ranks``, the second half of the ranks left
    out, the rest counted double; ``altered``, one answer changed where
    it is produced (the first element of rank 0's first leaf, +1);
    ``control_fp8``, the control: the float8 ring mean of
    ``reference/sync.py`` in the sync's place.
"""

from __future__ import annotations

import contextlib

import torch

TRAIN = ("unchanged", "half_batch", "no_exchange", "one_rank")
SYNC = ("no_exchange", "half_ranks", "altered", "control_fp8")


def _tree_map(fn, t):
    if isinstance(t, dict):
        return {k: _tree_map(fn, v) for k, v in t.items()}
    return fn(t)


def _returns(out_tree, state, arenas):
    return (out_tree, state, arenas) if arenas is not None \
        else (out_tree, state)


# -- training ---------------------------------------------------------------

def _unchanged(step):
    def fn(state, batch):
        return state, step(state, batch)[1]
    return fn


def _half_batch(step):
    def fn(state, batch):
        n = step.mesh.rank_shape[0]
        b = batch["tokens"].shape[0] // n
        rows = torch.cat([torch.arange(r * b, r * b + b // 2)
                          for r in range(n)])
        return step(state, {k: None if v is None else v[rows]
                            for k, v in batch.items()})
    fn.mesh = step.mesh
    return fn


def _one_rank(local_grads):
    def fn(model, state, batch, mesh, **kw):
        b = batch["tokens"].shape[0] // mesh.rank_shape[0]
        rows = torch.arange(batch["tokens"].shape[0])
        rows[:b] = rows[b:2 * b]
        return local_grads(model, state,
                           {k: None if v is None else v[rows]
                            for k, v in batch.items()}, mesh, **kw)
    return fn


# -- a gradient sync --------------------------------------------------------

def _no_exchange(sync):
    def fn(grads, state, *a, arenas=None, **kw):
        return _returns(grads, state, arenas)
    return fn


def _half_ranks(sync):
    def cut(t):
        t = t.clone()
        t[t.shape[0] // 2:] = 0
        return t * 2

    def fn(grads, state, *a, **kw):
        return sync(_tree_map(cut, grads), state, *a, **kw)
    return fn


def _altered(sync):
    def fn(grads, state, *a, **kw):
        out = sync(grads, state, *a, **kw)
        leaf = out[0]
        while isinstance(leaf, dict):
            leaf = leaf[sorted(leaf)[0]]
        leaf[0].view(-1)[0] += 1.0
        return out
    return fn


def _control_fp8(sync):
    from portbench.reference.sync import fp8_ring_mean

    def fn(grads, state, *a, arenas=None, **kw):
        return _returns(_tree_map(lambda t: fp8_ring_mean(t).to(t.dtype)
                                  .expand(t.shape), grads), state, arenas)
    return fn


_STEP = {"unchanged": _unchanged, "half_batch": _half_batch}
_SYNC = {"no_exchange": _no_exchange, "half_ranks": _half_ranks,
         "altered": _altered, "control_fp8": _control_fp8}


@contextlib.contextmanager
def planted(name: str):
    """Within the block, the port's timed path has the fault ``name``."""
    import repro_torch.core as core
    from repro_torch.train import step as S

    if name in _STEP:
        target, attr = S, "build_train_step_acis"
        real = S.build_train_step_acis

        def patched(*a, **kw):
            return _STEP[name](real(*a, **kw))
    elif name == "one_rank":
        target, attr = S, "local_grads"
        patched = _one_rank(S.local_grads)
    elif name in _SYNC:
        target, attr = core, "make_engine"
        real = core.make_engine

        def patched(*a, **kw):
            eng = real(*a, **kw)
            eng.gradient_sync = _SYNC[name](eng.gradient_sync)
            return eng
    else:
        raise KeyError(f"no fault {name!r}")
    saved = getattr(target, attr)
    setattr(target, attr, patched)
    try:
        yield
    finally:
        setattr(target, attr, saved)
