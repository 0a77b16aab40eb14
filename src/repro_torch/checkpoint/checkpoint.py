"""Atomic, verified, resumable checkpoints in the reference's layout.

The port of :mod:`repro.checkpoint.checkpoint`, writing the same files:

    <dir>/step_00000120/
        manifest.json        leaf paths, shapes, dtypes, checksums, step
        leaf_00000.npy ...   one file per pytree leaf
    <dir>/LATEST             atomic pointer (renamed into place)

A leaf's ``path`` is the string ``jax.tree_util.keystr`` gives the same
leaf of the reference's tree (a :class:`~repro_torch.train.step.
TrainState`'s children are ``[<flat index i>]``, dict keys ``['name']``,
sequence items ``[i]``), bf16 and fp8 leaves are stored as ``uint16`` /
``uint8`` views with the logical dtype in the manifest, and each leaf
carries ``sha256(bytes)[:16]``: a checkpoint written by either package
restores in the other, leaf for leaf (no ``ml_dtypes`` needed here).

Contract, as the reference's: saves are atomic (tmp dir, fsync'd
manifest, rename), ``restore`` verifies every checksum and refuses a
corrupt leaf, and ``keep_last`` trims old steps only after ``LATEST``
points at the new one.  Two differences of layout, by design: a
``TrainState``'s ``sync_arenas`` are left out (scratch, rank-stacked;
every pack overwrites them, and ``restore`` keeps the target's), and its
``ef_residual`` is the port's ``[*rank, ...]`` — every rank's, where the
reference's global array holds one rank's copy (ROADMAP.md §3).
``restore(..., device=)`` replaces the reference's ``shardings=``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.step import TrainState

PyTree = Any

# dtypes numpy cannot hold: stored as raw integer views, the logical
# dtype recorded in the manifest
_EXOTIC = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16, np.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8, np.uint8),
}
_BY_TORCH = {v[0]: k for k, v in _EXOTIC.items()}


def _to_storable(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    name = _BY_TORCH.get(t.dtype)
    if name is not None:
        _, int_t, store_np, _ = _EXOTIC[name]
        return t.contiguous().view(int_t).numpy().view(store_np), name
    arr = t.numpy()
    return arr, arr.dtype.name


def _from_storable(arr: np.ndarray, logical: str) -> torch.Tensor:
    arr = arr if arr.flags.c_contiguous else arr.copy()   # keeps 0-dim
    if logical in _EXOTIC:
        dt, _, _, view_np = _EXOTIC[logical]
        return torch.from_numpy(arr.view(view_np)).view(dt)
    return torch.from_numpy(arr)


def _state_children(t) -> Optional[list]:
    """A TrainState's children as the reference flattens it (its
    ``sync_arenas`` left out)."""
    if isinstance(t, TrainState):
        return [t.params, t.opt, t.step, t.ef_residual]
    return None


def _leaf_paths(t: PyTree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(keystr path, leaf)`` in the reference's flatten order."""
    kids = _state_children(t)
    if kids is not None:
        out = []
        for i, k in enumerate(kids):
            out += _leaf_paths(k, f"{prefix}[<flat index {i}>]")
        return out
    if isinstance(t, dict):
        out = []
        for key in sorted(t):
            out += _leaf_paths(t[key], f"{prefix}[{key!r}]")
        return out
    if isinstance(t, (list, tuple)):
        out = []
        for i, x in enumerate(t):
            out += _leaf_paths(x, f"{prefix}[{i}]")
        return out
    if t is None:
        return []
    return [(prefix, t)]


def _rebuild(like: PyTree, leaves: dict, prefix: str = "") -> PyTree:
    kids = _state_children(like)
    if kids is not None:
        built = [_rebuild(k, leaves, f"{prefix}[<flat index {i}>]")
                 for i, k in enumerate(kids)]
        return dataclasses.replace(like, params=built[0], opt=built[1],
                                   step=built[2], ef_residual=built[3])
    if isinstance(like, dict):
        return {key: _rebuild(like[key], leaves, f"{prefix}[{key!r}]")
                for key in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, leaves, f"{prefix}[{i}]")
                          for i, x in enumerate(like))
    if like is None:
        return None
    return leaves[prefix]


def _checksum(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def save(ckpt_dir: str, step: int, tree: PyTree, *, keep_last: int = 3,
         extra: Optional[dict] = None, specs: Optional[PyTree] = None,
         mesh=None) -> str:
    """Write ``tree`` as global arrays.  A tree of rank-stacked shards
    (the GSPMD step's layout) comes with its ``specs`` and ``mesh`` and is
    gathered first, so any layout restores it."""
    if specs is not None:
        from repro_torch.sharding.rules import unshard_tree
        tree = unshard_tree(tree, specs, mesh)
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _leaf_paths(tree)
    step_name = f"step_{step:08d}"
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_{step_name}_")
    manifest = {"step": step, "leaves": [], "extra": extra or {},
                "treedef": f"repro_torch ({len(flat)} leaves)"}
    try:
        for i, (path, leaf) in enumerate(flat):
            stored, logical = _to_storable(leaf)
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), stored)
            manifest["leaves"].append({
                "path": path, "file": fname,
                "shape": list(stored.shape), "dtype": logical,
                "checksum": _checksum(stored)})
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(ckpt_dir, step_name)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic LATEST pointer
    latest_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(step_name)
        f.flush()
        os.fsync(f.fileno())
    os.rename(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    _trim(ckpt_dir, keep_last)
    return final


def _trim(ckpt_dir: str, keep_last: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, like: PyTree, *, step: Optional[int] = None,
            device=None, verify: bool = True, specs: Optional[PyTree] = None,
            mesh=None) -> tuple[PyTree, int, dict]:
    """Restore into the structure of ``like`` (its leaves' global shapes
    are checked).  Leaves go to ``device``, else to the device of
    ``like``'s leaf (the CPU for a ``meta`` one).  With ``specs`` and
    ``mesh`` (the reference's ``shardings=``) every leaf is then split
    into that layout on the mesh's device (``LocalMesh.shard``).
    Returns (tree, step, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {m["path"]: m for m in manifest["leaves"]}
    leaves = {}
    for ps, leaf_like in _leaf_paths(like):
        meta = by_path.get(ps)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {ps}")
        raw = np.load(os.path.join(d, meta["file"]))
        if verify and _checksum(raw) != meta["checksum"]:
            raise IOError(f"checksum mismatch for {ps} — corrupt shard")
        t = _from_storable(raw, meta["dtype"])
        if list(t.shape) != list(leaf_like.shape):
            raise ValueError(
                f"shape mismatch for {ps}: ckpt {tuple(t.shape)} vs "
                f"target {tuple(leaf_like.shape)}")
        dev = device if device is not None else leaf_like.device
        if torch.device(dev).type == "meta":
            dev = "cpu"
        leaves[ps] = t.to(dev)
    out = _rebuild(like, leaves)
    if specs is not None:
        from repro_torch.sharding.rules import shard_tree
        out = shard_tree(out, specs, mesh)
    return out, manifest["step"], manifest.get("extra", {})
