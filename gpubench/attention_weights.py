"""Learned weights of a net with the attention peak head, for both sides.

``weights.state_dict`` refuses an attention head; this reader reads the
same checkpoint with the same frozen msgpack reader (``weights.decode``)
and renames every leaf as it does (a Dense ``kernel`` (in, out) becomes
``weight`` (out, in)), and lays out flax's ``MultiHeadDotProductAttention``
projections (DenseGeneral) as the port model's Linear layers:

- ``query``, ``key``, ``value``: kernel (in, heads, head_dim) -> weight
  (heads * head_dim, in), bias (heads, head_dim) -> (heads * head_dim,);
- ``out``: kernel (heads, head_dim, out) -> weight (out, heads * head_dim).

Heads are the leading factor of the folded axis, as the port's attention
reshapes its projections to (heads, head_dim)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from gpubench.weights import _flatten, decode


def state_dict(path: Path) -> Dict[str, torch.Tensor]:
    """The checkpoint's parameters (``["params"]["params"]``) under the port
    model's state_dict keys, float32 CPU tensors."""
    tree = decode(Path(path).read_bytes())["params"]["params"]
    out = {}
    for path_, leaf in _flatten(tree):
        *mods, name = path_
        x = np.array(leaf, dtype=np.float32)
        attention = len(mods) >= 2 and mods[-2] == "attention"
        if name == "kernel":
            if attention:
                x = x.reshape(-1, x.shape[-1]) if mods[-1] == "out" else x.reshape(x.shape[0], -1)
            name, x = "weight", x.T
        elif name == "bias" and attention:
            x = x.reshape(-1)
        out[".".join((*mods, name))] = torch.from_numpy(x).contiguous()
    return out
