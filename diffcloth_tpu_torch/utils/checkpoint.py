"""Checkpoint / resume for optimization runs.

Counterpart of `diffcloth_tpu/utils/checkpoint.py` (reference: the
per-iteration parameter logs and `saveLastIter`, OptimizeHelper.cpp
:528-533): checkpoints live in `root/ckpt_%08d/` folders, the newest
`keep` of them are kept.  A checkpoint is plain NumPy: the tree's arrays
in `arrays.npz`, its structure in `tree.json` and the caller's metadata
in `metadata.json`.  The port reads only its own checkpoints; the JAX
package's (orbax) folders are another format.

A tree is a nest of dicts, lists, tuples and dataclasses (`SimParams`)
whose leaves are torch tensors, numpy arrays or Python numbers.  Every
leaf comes back as a numpy array, dataclasses as dicts of their fields,
unless `like` gives the structure to restore into.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np

_DIR = re.compile(r"ckpt_(\d+)")


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"ckpt_{step:08d}")


def _is_tensor(a) -> bool:
    return type(a).__module__.startswith("torch")


def _flatten(tree, prefix: str, arrays: Dict[str, np.ndarray]):
    """The tree's structure as JSON, its leaves stored under their paths."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {"dict": {k: _flatten(v, f"{prefix}/{k}", arrays)
                         for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"list": [_flatten(v, f"{prefix}/{i}", arrays)
                         for i, v in enumerate(tree)]}
    if _is_tensor(tree):
        tree = tree.detach().cpu().numpy()
    arrays[prefix] = np.asarray(tree)
    return {"leaf": prefix}


def _unflatten(spec, arrays):
    if "dict" in spec:
        return {k: _unflatten(v, arrays) for k, v in spec["dict"].items()}
    if "list" in spec:
        return [_unflatten(v, arrays) for v in spec["list"]]
    return arrays[spec["leaf"]]


def _into(like, tree):
    """`tree` (restored dicts, lists and arrays) rebuilt in the structure
    and leaf types of `like`."""
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _into(getattr(like, f.name), tree[f.name])
            for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        return {k: _into(v, tree[k]) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_into(v, t) for v, t in zip(like, tree)]
        return type(like)(out) if isinstance(like, list) else tuple(out)
    if _is_tensor(like):
        import torch
        return torch.as_tensor(tree).to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return np.asarray(tree, like.dtype)
    if isinstance(like, (int, float, bool)):
        return type(like)(tree)
    return tree


def save_checkpoint(root: str, step: int, tree: Any,
                    metadata: Optional[Dict] = None,
                    keep: int = 5) -> str:
    """Save `tree` at `root/ckpt_{step:08d}` (replacing one that is there)
    and keep only the newest `keep` checkpoints.  Returns the path."""
    os.makedirs(root, exist_ok=True)
    path = _step_dir(root, step)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)
    arrays: Dict[str, np.ndarray] = {}
    spec = _flatten(tree, "", arrays)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "tree.json"), "w") as fh:
        json.dump(spec, fh)
    if metadata is not None:
        with open(os.path.join(path, "metadata.json"), "w") as fh:
            json.dump({"step": step, **metadata}, fh, indent=1)
    _gc_old(root, keep)
    return path


def _steps(root: str):
    return sorted(int(m.group(1)) for f in os.listdir(root)
                  if (m := _DIR.fullmatch(f)))


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = _steps(root)
    return steps[-1] if steps else None


def restore_checkpoint(root: str, step: Optional[int] = None,
                       like: Any = None) -> Tuple[int, Any]:
    """Restore (step, tree); step=None restores the latest.  With `like`
    (an example tree) the result takes its structure, dataclasses and leaf
    types (tensors on like's device and dtype)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    path = _step_dir(root, step)
    with open(os.path.join(path, "tree.json")) as fh:
        spec = json.load(fh)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    tree = _unflatten(spec, arrays)
    return step, (tree if like is None else _into(like, tree))


def _gc_old(root: str, keep: int) -> None:
    for s in _steps(root)[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)
