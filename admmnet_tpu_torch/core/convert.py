"""Carry configuration across from the JAX package.

The classical pipeline has no learned weights: what moves between the two
packages is the option dataclasses.  ``options_from_jax`` accepts a JAX
``ADMMOptions`` / ``PeakSearchConfig`` / ``ProblemSpec`` instance, its
``dataclasses.asdict`` dictionary, or its JSON text, and returns the port's
dataclass with the same field values.  It reads the object's fields only,
so the JAX package is never imported here.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

from admmnet_tpu_torch.core.config import (
    ADMMOptions,
    PeakSearchConfig,
    ProblemSpec,
    _from_dict,
)

_CLASSES = {c.__name__: c for c in (ADMMOptions, PeakSearchConfig, ProblemSpec)}
# a field that only one of the classes has, to recognize a bare dictionary
_MARKERS = (("g_update", ADMMOptions), ("refine_points", PeakSearchConfig),
            ("Nb", ProblemSpec))


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
