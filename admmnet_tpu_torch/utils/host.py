"""Host <-> device boundary helpers for trees of arrays, complex included.

Counterparts of the JAX package's ``utils/host.py``.  There they work
around a TPU backend on which complex arrays cannot cross the host-device
boundary (the helpers move them as float pairs and recombine them inside
jit).  torch moves complex tensors across as they are, so here the helpers
keep only their role at the boundary: ``to_host`` fetches a tree of tensors
as numpy, ``to_device`` puts a tree of numpy leaves on an explicit device,
and ``cjit(fn, device=...)`` moves the host numpy leaves of its arguments
there before it calls ``fn``.  ``cjit`` compiles nothing: the kernels are
compiled CUDA, and the rest runs eagerly.  A tree is nested dicts, lists
and tuples; any other leaf passes through unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["cjit", "to_device", "to_host"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, tuple):  # a named tuple
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    return fn(tree)


def _fetch_leaf(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().resolve_conj().numpy()
    if isinstance(v, (np.ndarray, np.generic, int, float, bool, complex)):
        return np.asarray(v)
    return v


def to_host(tree):
    """A tree of tensors as host numpy arrays (complex stays complex); numpy
    leaves and Python scalars as numpy arrays."""
    return _tree_map(_fetch_leaf, tree)


def to_device(tree, device):
    """A tree with its numpy array leaves, complex included, as tensors on
    ``device``; tensors are moved there too, other leaves pass through."""
    dev = torch.device(device)

    def put(v):
        if isinstance(v, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        if isinstance(v, torch.Tensor):
            return v.to(dev)
        return v

    return _tree_map(put, tree)


def cjit(fn=None, *, device="cuda"):
    """``fn`` behind the host boundary: its positional arguments' numpy
    leaves (complex included) go to ``device`` as tensors before the call;
    the outputs stay on the device (``to_host`` fetches them).  Use as
    ``cjit(fn, device=...)`` or as a decorator, ``@cjit`` or
    ``@cjit(device=...)``."""

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args):
            return f(*to_device(args, device))

        return wrapper

    return deco(fn) if fn is not None else deco
