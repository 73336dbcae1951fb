"""Read and write checkpoints in the JAX package's format.

A checkpoint directory holds ``best_model.msgpack`` (flax's msgpack
serialization of the training state ``{"params": variables, "opt_state":
...}``) and ``metadata.json``.  ``restore_checkpoint`` decodes the whole
file with a minimal msgpack reader of its own and ``save_checkpoint``
writes one with its inverse, so neither ``msgpack`` nor ``flax`` is needed:
they cover the msgpack types nil, bool, int, float, str, bin, array and
map, and flax's extension types 1 (ndarray, packed as the msgpack array
(shape, dtype name, C-order bytes)), 2 (Python complex) and 3 (numpy
scalar).  ``core.convert.params_from_jax`` turns
``state["params"]["params"]`` into the port model's state_dict and
``params_to_jax`` back, so the JAX package's ``restore_checkpoint`` reads
the parameters the port writes.
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


def _header(n: int, fix, fix_limit: int, code8, code16: int, code32: int) -> bytes:
    """Header of a msgpack object of size n: the fix form ``fix | n`` below
    ``fix_limit`` (where the type has one), else the 8-bit (where the type
    has one), 16- or 32-bit form."""
    if fix is not None and n < fix_limit:
        return bytes([fix | n])
    if code8 is not None and n < 1 << 8:
        return struct.pack(">BB", code8, n)
    if n < 1 << 16:
        return struct.pack(">BH", code16, n)
    return struct.pack(">BI", code32, n)


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(len(data))
    head = bytes([fixed]) if fixed else _header(len(data), None, 0, 0xC7, 0xC8, 0xC9)
    return head + struct.pack(">b", code) + data


def _pack(x, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif isinstance(x, (bool, np.bool_)):
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        if 0 <= x < 0x80 or -32 <= x < 0:
            out.append(struct.pack(">b" if x < 0 else ">B", x))
        elif x >= 0:
            out.append(struct.pack(">BQ", 0xCF, x))
        else:
            out.append(struct.pack(">Bq", 0xD3, x))
    elif isinstance(x, float):
        out.append(struct.pack(">Bd", 0xCB, x))
    elif isinstance(x, str):
        b = x.encode("utf-8")
        out.append(_header(len(b), 0xA0, 32, 0xD9, 0xDA, 0xDB) + b)
    elif isinstance(x, bytes):
        out.append(_header(len(x), None, 0, 0xC4, 0xC5, 0xC6) + x)
    elif isinstance(x, np.ndarray):
        out.append(_pack_ext(_EXT_NDARRAY, _ndarray_bytes(x)))
    elif isinstance(x, np.generic):
        out.append(_pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(x))))
    elif isinstance(x, complex):
        out.append(_pack_ext(_EXT_COMPLEX, msgpack_encode((x.real, x.imag))))
    elif isinstance(x, (list, tuple)):
        out.append(_header(len(x), 0x90, 16, None, 0xDC, 0xDD))
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        out.append(_header(len(x), 0x80, 16, None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot encode {type(x).__name__} as msgpack")


def _ndarray_bytes(a: np.ndarray) -> bytes:
    return msgpack_encode((a.shape, a.dtype.name, a.tobytes("C")))


def msgpack_encode(value: Any) -> bytes:
    """One msgpack document of ``value`` (flax's encoding of numpy arrays,
    numpy scalars and complex numbers included); the inverse of
    ``msgpack_decode``.  Dict keys are written as given."""
    out: list = []
    _pack(value, out)
    return b"".join(out)


def save_checkpoint(ckpt_dir, state: Dict[str, Any], metadata: Dict[str, Any]) -> None:
    """Atomically write ``state`` (nested dicts of numpy arrays and Python
    scalars) as ``best_model.msgpack`` and ``metadata`` as
    ``metadata.json``: each goes to a temporary file that then replaces the
    old one."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / "best_model.msgpack.tmp"
    tmp.write_bytes(msgpack_encode(state))
    tmp.replace(d / "best_model.msgpack")
    mtmp = d / "metadata.json.tmp"
    mtmp.write_text(json.dumps(metadata, indent=2))
    mtmp.replace(d / "metadata.json")


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
