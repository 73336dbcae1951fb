"""Carry configuration and learned weights across from the JAX package.

``options_from_jax`` accepts a JAX ``ADMMOptions`` / ``PeakSearchConfig`` /
``ProblemSpec`` / ``ModelConfig`` / ``DataConfig`` / ``TrainConfig``
instance, its ``dataclasses.asdict`` dictionary (such as
``runs/*/config.json["model"]`` or ``["train"]``), or its JSON text, and
returns the port's dataclass with the same field values.
``params_from_jax`` turns a flax parameter tree (nested dicts of numpy
arrays, as ``train.checkpoint.restore_checkpoint`` returns it) into the
state_dict of the port's model, and ``params_to_jax`` turns a state_dict
back into that tree.  All of them read plain Python data only, so the JAX
package is never imported here.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import numpy as np
import torch

from admmnet_tpu_torch.core.config import (
    ADMMOptions,
    DataConfig,
    ModelConfig,
    PeakSearchConfig,
    ProblemSpec,
    TrainConfig,
    _from_dict,
)

_CLASSES = {c.__name__: c for c in (ADMMOptions, PeakSearchConfig, ProblemSpec, ModelConfig,
                                    DataConfig, TrainConfig)}
# a field that only one of the classes has, to recognize a bare dictionary
_MARKERS = (("g_update", ADMMOptions), ("refine_points", PeakSearchConfig),
            ("num_layers", ModelConfig), ("Nb", ProblemSpec), ("snr_demod", DataConfig),
            ("sgdr_t0", TrainConfig))


def options_from_jax(obj: Any, cls: Optional[type] = None):
    """The port's counterpart of a JAX configuration object.

    ``obj``: a dataclass instance, a dict, or a JSON string.  ``cls`` names
    the port class when ``obj`` is a dict or JSON and the class cannot be
    told from its fields.  Raises ``ValueError`` on a field the port class
    does not have, so a JAX-side field added later cannot be dropped
    silently.
    """
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if name not in _CLASSES:
            raise ValueError(f"no port counterpart for {name}")
        cls = cls or _CLASSES[name]
        d = dataclasses.asdict(obj)
    elif isinstance(obj, str):
        d = json.loads(obj)
    elif isinstance(obj, dict):
        d = dict(obj)
    else:
        raise TypeError(f"cannot convert {type(obj).__name__}")
    if cls is None:
        for key, c in _MARKERS:
            if key in d:
                cls = c
                break
        else:
            raise ValueError("cannot tell the configuration class; pass cls=")
    unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return _from_dict(cls, d)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert_leaf(path, leaf):
    """(state_dict key, tensor) of one flax leaf."""
    *mods, name = path
    x = torch.from_numpy(np.array(leaf, dtype=np.float32))
    attention = len(mods) >= 2 and mods[-2] == "attention"
    if name == "kernel":
        if attention:
            # DenseGeneral: query/key/value (in, heads, head_dim), out (heads, head_dim, out)
            x = x.reshape(-1, x.shape[-1]) if mods[-1] == "out" else x.reshape(x.shape[0], -1)
        name, x = "weight", x.T
    elif name == "bias" and attention:
        x = x.reshape(-1)
    return ".".join((*mods, name)), x.contiguous()


def flax_to_state_dict(tree):
    """The renaming alone: a flax parameter tree (of a model or of one
    layer) as a state_dict.  Dense kernels (in, out) become
    ``Linear.weight`` (out, in); the attention projections of
    ``PeakSearchHead`` fold (heads, head_dim) into one axis; scalars stay
    0-d."""
    return dict(_convert_leaf(path, leaf) for path, leaf in _flatten(tree))


def params_from_jax(tree, cfg: ModelConfig):
    """State_dict of the port's model for a flax parameter tree.

    ``tree`` is the flax ``params`` collection (the checkpoint state's
    ``["params"]["params"]``).  A tree with a ``peak_head`` is an
    ``ADMMNet``, one without a ``PhiEstADMMNet``.  Raises ``ValueError`` on
    a leaf that is missing, left over, or of another shape than the port's
    parameter.
    """
    from admmnet_tpu_torch.models import ADMMNet, PhiEstADMMNet

    model = (ADMMNet if "peak_head" in tree else PhiEstADMMNet)(cfg)
    want = model.state_dict()
    got = flax_to_state_dict(tree)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"flax tree does not fit {type(model).__name__}: "
                         f"missing {missing}, left over {extra}")
    bad = [k for k in want if want[k].shape != got[k].shape]
    if bad:
        raise ValueError("shape mismatch: " + ", ".join(
            f"{k} {tuple(got[k].shape)} vs {tuple(want[k].shape)}" for k in bad))
    return {k: got[k] for k in want}


def _leaf_to_flax(key: str, x: torch.Tensor, num_heads: int):
    """(flax path, numpy array) of one state_dict entry; the inverse of
    ``_convert_leaf``."""
    *mods, name = key.split(".")
    a = x.detach().cpu().to(torch.float32).numpy()
    attention = len(mods) >= 2 and mods[-2] == "attention"
    if name == "weight":
        name, a = "kernel", a.T
        if attention:
            heads = (num_heads, a.shape[0] // num_heads) if mods[-1] == "out" else (
                num_heads, a.shape[1] // num_heads)
            a = a.reshape(*heads, -1) if mods[-1] == "out" else a.reshape(a.shape[0], *heads)
    elif name == "bias" and attention and mods[-1] != "out":
        a = a.reshape(num_heads, -1)
    return (*mods, name), np.array(a, dtype=np.float32, order="C")


def params_to_jax(state_dict, cfg: ModelConfig):
    """The flax ``params`` collection (nested dicts of numpy float32 arrays,
    scalars 0-d) of a port state_dict; the inverse of ``params_from_jax``.
    Wrap it as ``{"params": tree}`` for flax's ``Module.apply``."""
    tree: dict = {}
    for key, x in state_dict.items():
        path, a = _leaf_to_flax(key, x, cfg.num_heads)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return tree
