"""Runtime validation guards (PyTorch port of `icp4dradar_tpu/utils/debug.py`):
NaN/Inf poisoning and malformed scans.

`checked(fn)` runs fn under a dispatch mode that checks the output of every
torch op, so a non-finite value made inside fn raises even when fn masks it
away before returning. `validate_scan` / `assert_finite_tree` are host-side
preflight checks for pipeline entry points.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Iterator, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# ops whose output is uninitialized memory, not a value computed from inputs
_UNINITIALIZED = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided")


def _nonfinite(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point() and not bool(torch.isfinite(x).all())
    return isinstance(x, float) and not math.isfinite(x)


class _FloatCheckMode(TorchDispatchMode):
    """Raises FloatingPointError when an op makes a NaN or an Inf from
    inputs (tensors and scalars) that hold none: the counterpart of
    checkify's float_checks (a NaN from non-NaN inputs, a division by
    zero)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        clean = not any(_nonfinite(x) for x in tree_leaves((args, kwargs)))
        out = func(*args, **kwargs)
        if clean and func.overloadpacket.__name__ not in _UNINITIALIZED:
            bad = [x for x in tree_leaves(out) if _nonfinite(x)]
            if bad:
                n = sum(int((~torch.isfinite(x)).sum()) for x in bad)
                raise FloatingPointError(
                    f"{n} non-finite values generated by op {func} from finite inputs")
        return out


def checked(fn):
    """Wrap fn so that an op inside it that makes a NaN or an Inf from
    finite inputs raises FloatingPointError naming the op. For debugging
    only: every op's output is checked on the host, so on the card each op
    synchronizes."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _FloatCheckMode():
            return fn(*args, **kwargs)

    return run


def _leaves_with_path(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in the JAX package's flattening order, the path
    written as jax.tree_util.keystr writes it: `.field` for a dataclass
    field, `[key]` for a dict key (keys sorted) or a sequence index."""
    if tree is None:
        return
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves_with_path(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves_with_path(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_finite_tree(tree: Any, name: str = "pytree") -> None:
    """Host-side: raise if any array leaf (tensor, numpy array or float)
    contains NaN/Inf, naming its path."""
    for path, leaf in _leaves_with_path(tree):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(f"{name}{path}: {bad} non-finite values")


def validate_scan(scan, name: str = "scan") -> None:
    """Preflight a RadarScan: shapes consistent, mask binary, finite data
    in valid slots."""
    n = scan.xyz.shape[0]
    for field in ("doppler", "intensity", "mask"):
        arr = getattr(scan, field)
        if arr.shape[0] != n:
            raise ValueError(f"{name}.{field} length {arr.shape[0]} != {n}")
    m = scan.mask.cpu().numpy()
    if not np.isin(m, (0.0, 1.0)).all():
        raise ValueError(f"{name}.mask must be binary 0/1")
    valid = m > 0.5
    xyz = scan.xyz.cpu().numpy()[valid]
    if not np.isfinite(xyz).all():
        raise FloatingPointError(f"{name}: non-finite coordinates in valid points")
