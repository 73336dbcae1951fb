"""Numerical-debug helpers; counterpart of ``admmnet_tpu/utils/debug.py``.

- ``nan_guard()``: context manager under which the first torch operation
  that produces a NaN raises ``FloatingPointError`` naming that operation
  (a ``TorchFunctionMode`` checks every output, as ``jax_debug_nans``
  checks every primitive), with ``torch.autograd.set_detect_anomaly``
  on, so a NaN made in a backward pass raises at its op too and names the
  forward op it came from;
- ``check_finite(tree)``: finiteness check of a tree of tensors / arrays,
  raising with the offending path.

The JAX module's docstring also names ``donation_safe``; neither package
defines it, and torch has no buffer donation for it to guard.
"""

from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch
from torch.overrides import TorchFunctionMode


def _has_nan(x) -> bool:
    return (isinstance(x, torch.Tensor) and (x.is_floating_point() or x.is_complex())
            and bool(torch.isnan(x).any()))


class _NaNMode(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if any(_has_nan(o) for o in outs):
            name = getattr(func, "__qualname__", None) or getattr(func, "__name__", str(func))
            raise FloatingPointError(f"NaN produced by {name}")
        return out


@contextlib.contextmanager
def nan_guard():
    with torch.autograd.set_detect_anomaly(True), _NaNMode():
        yield


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def check_finite(tree: Any, name: str = "tree") -> None:
    """Raise FloatingPointError naming the first non-finite leaf."""
    for path, leaf in _paths(tree):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if arr.dtype.kind in "fc" and not np.all(np.isfinite(arr)):
            bad = int(np.sum(~np.isfinite(arr)))
            raise FloatingPointError(f"{name}{path}: {bad}/{arr.size} non-finite values")
