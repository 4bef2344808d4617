"""Checkpointing: save and restore a tree of arrays on disk.

Port of the disk part of ``repro.training.checkpoint``, with the same
layout, so a checkpoint written by either package restores in the
other: ``<dir>/step_<n:08d>/arrays.npz`` (the leaves as numpy, keyed
``a<i>`` in the order of their sorted paths), ``tree.json``
(``{"paths": [...]}``, each path its keys joined by ``/``) and
``meta.json`` (``{"step": n, ...}``).  Trees are nested dicts, lists
and tuples, visited as ``jax.tree`` visits them: dict keys sorted, a
sequence by index; leaves are tensors (copied to the host) or numpy
arrays.

``save`` is atomic: the snapshot is staged into ``step_<n>.tmp`` and
renamed into place, so a process dying mid-save never leaves a corrupt
*latest* checkpoint; ``latest_step`` and ``restore`` skip ``.tmp``
leftovers.  ``restore`` checks every path and shape against the target
structure and returns numpy leaves.

The reference's pool-resident store (``PoolCheckpointStore``: double-
buffered snapshot slots in the CXL pool, committed by a doorbell) is
not ported yet (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree: Any, prefix: tuple = ()) -> list:
    """[(path, leaf)]: dict keys in sorted order, sequences by index."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten(x, prefix + (i,))]
    return [(prefix, tree)]


def _unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _path_str(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any,
         meta: Optional[dict] = None) -> str:
    """Atomic save: stage into ``step_<n>.tmp``, rename into place."""
    out = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = out + ".tmp"
    if os.path.isdir(tmp):  # stale leftover from a process that died
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {}
    index = []
    for i, (path, leaf) in enumerate(_flatten(tree)):
        arrays[f"a{i}"] = _to_numpy(leaf)
        index.append(_path_str(path))
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump({"paths": index}, f)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, **(meta or {})}, f)
    if os.path.isdir(out):  # re-save of the same step
        shutil.rmtree(out)
    os.rename(tmp, out)  # the commit point
    return out


def _step_of(name: str) -> Optional[int]:
    """Step index of a committed checkpoint dir name, else None
    (``.tmp`` staging leftovers and strangers are not checkpoints)."""
    if not name.startswith("step_") or name.endswith(".tmp"):
        return None
    try:
        return int(name.split("_", 1)[1])
    except ValueError:
        return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [s for d in os.listdir(ckpt_dir)
             if (s := _step_of(d)) is not None]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like`` (validates paths and
    shapes; a leaf with a ``shape`` - a tensor, meta tensors included,
    or an array - must match it).  Only committed checkpoints are
    eligible; a ``step_<n>.tmp`` leftover is never read."""
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.isdir(src):
        hint = (" (a .tmp staging dir exists: the save was interrupted "
                "before commit)" if os.path.isdir(src + ".tmp") else "")
        raise FileNotFoundError(f"no committed checkpoint at {src}{hint}")
    with open(os.path.join(src, "tree.json")) as f:
        saved_paths = json.load(f)["paths"]
    flat = _flatten(like)
    if len(flat) != len(saved_paths):
        raise ValueError(
            f"checkpoint has {len(saved_paths)} leaves, target structure "
            f"has {len(flat)}")
    leaves = []
    with np.load(os.path.join(src, "arrays.npz")) as data:
        for i, (path, leaf) in enumerate(flat):
            ps = _path_str(path)
            if ps != saved_paths[i]:
                raise ValueError(
                    f"leaf {i} path mismatch: checkpoint "
                    f"{saved_paths[i]!r} vs target {ps!r}")
            arr = data[f"a{i}"]
            if hasattr(leaf, "shape") and \
                    tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"{ps}: shape {arr.shape} != {tuple(leaf.shape)}")
            leaves.append(arr)
    return _unflatten(like, iter(leaves))


def load_meta(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)
