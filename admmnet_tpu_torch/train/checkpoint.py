"""Read the checkpoints the JAX package writes.

A checkpoint directory holds ``best_model.msgpack`` (flax's msgpack
serialization of the training state ``{"params": variables, "opt_state":
...}``) and ``metadata.json``.  ``restore_checkpoint`` decodes the whole
file with a minimal msgpack reader of its own, so neither ``msgpack`` nor
``flax`` is needed: it covers the msgpack types nil, bool, int, float, str,
bin, array and map, and flax's extension types 1 (ndarray, packed as the
msgpack array (shape, dtype name, C-order bytes)), 2 (Python complex) and
3 (numpy scalar).  ``core.convert.params_from_jax`` turns
``state["params"]["params"]`` into the port model's state_dict.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3

# type byte -> value (nil, false, true)
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
# type byte -> struct format of a number
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# type byte -> (kind, struct format of its length or count)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
          0xD9: ("text", ">B"), 0xDA: ("text", ">H"), 0xDB: ("text", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
# fixext type byte -> payload length
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    """Decoder of one msgpack document held in memory."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext(code, bytes(self.take(n)))

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if t <= 0x8F:
            return self.map(t & 0x0F)
        if t <= 0x9F:
            return self.array(t & 0x0F)
        if t <= 0xBF:
            return self.text(t & 0x1F)
        if t in _CONSTANTS:
            return _CONSTANTS[t]
        if t in _NUMBERS:
            return self.unpack(_NUMBERS[t])
        if t in _SIZED:
            kind, fmt = _SIZED[t]
            return getattr(self, kind)(self.unpack(fmt))
        if t in _FIXEXT:
            return self.ext(_FIXEXT[t])
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack_decode(data)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape, order="C")


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_COMPLEX:
        re, im = msgpack_decode(data)
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


def msgpack_decode(data: bytes) -> Any:
    """The Python value of one msgpack document (flax's encoding of arrays
    included); trailing bytes raise."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack document")
    return out


def restore_checkpoint(ckpt_dir) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
    """(state, metadata) of a checkpoint directory, or None if it holds no
    ``best_model.msgpack``."""
    d = Path(ckpt_dir)
    f = d / "best_model.msgpack"
    if not f.exists():
        return None
    state = msgpack_decode(f.read_bytes())
    meta = json.loads((d / "metadata.json").read_text())
    return state, meta
