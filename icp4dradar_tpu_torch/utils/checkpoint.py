"""Checkpoint / resume of pipeline state (PyTorch port of
`icp4dradar_tpu/utils/checkpoint.py`; the reference's only analog is the
CSV record/replay fixture, src/iterative_closest_point.cpp:188-206): a
{pose, map, frame index} state snapshots to one npz file and resumes at
scan k.

The file layout is the JAX package's: `leaf_0`, `leaf_1`, ... in the order
`jax.tree.flatten` visits the same structure, `__treedef__` (the structure's
text, as JAX prints it) and `__meta__` (JSON). So a file written by either
package loads in the other. The order: tuples and lists in order, dict
values by sorted key, a dataclass's fields in declaration order, and no
leaf for None. A dataclass field that holds a plain Python value (a map's
`voxel_size`, `max_probes`) is static: it is not stored, and comes back
from the structure given to `load_checkpoint`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_STATIC = (bool, int, float, str, bytes)


def _is_dataclass(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _flatten(x, leaves: List[Any]) -> str:
    """Append x's leaves in `jax.tree.flatten`'s order; return the
    structure's text as JAX prints a treedef."""
    if x is None:
        return "None"
    if _is_dataclass(x):
        children, static = [], []
        for f in dataclasses.fields(x):
            v = getattr(x, f.name)
            if isinstance(v, _STATIC):
                static.append(v)
            else:
                children.append(_flatten(v, leaves))
        return f"CustomNode({type(x).__name__}[{tuple(static)!r}], [{', '.join(children)}])"
    if isinstance(x, tuple):
        parts = [_flatten(v, leaves) for v in x]
        return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
    if isinstance(x, list):
        return "[" + ", ".join(_flatten(v, leaves) for v in x) + "]"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(x[k], leaves)}" for k in sorted(x)) + "}"
    leaves.append(x)
    return "*"


def _unflatten(like, leaves):
    """`like`'s structure with its leaves taken in order from the iterator
    `leaves`; static dataclass fields come from `like`."""
    if like is None:
        return None
    if _is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _unflatten(getattr(like, f.name), leaves)
            for f in dataclasses.fields(like)
            if not isinstance(getattr(like, f.name), _STATIC)})
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    return next(leaves)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, state: Any, metadata: Dict[str, Any] | None = None) -> None:
    """Snapshot a structure of tensors / arrays (tuples, lists, dicts, the
    port's dataclasses) and JSON-able metadata to `<path>.npz`."""
    leaves: List[Any] = []
    treedef = _flatten(state, leaves)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {f"leaf_{i}": _numpy(x) for i, x in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(f"PyTreeDef({treedef})".encode(), dtype=np.uint8)
    arrays["__meta__"] = np.frombuffer(json.dumps(metadata or {}).encode(), dtype=np.uint8)
    np.savez_compressed(_npz(path), **arrays)


def load_checkpoint(path: str, like: Any) -> Tuple[Any, Dict[str, Any]]:
    """Restore a structure shaped like `like` -> (state with numpy leaves,
    metadata). The caller places the leaves on its device."""
    n = len(_leaves_of(like))
    with np.load(_npz(path)) as f:
        leaves = [f[f"leaf_{i}"] for i in range(n)]
        meta = json.loads(bytes(f["__meta__"]).decode()) if "__meta__" in f else {}
    return _unflatten(like, iter(leaves)), meta


def _leaves_of(x) -> List[Any]:
    leaves: List[Any] = []
    _flatten(x, leaves)
    return leaves
