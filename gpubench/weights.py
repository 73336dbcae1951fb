"""Learned weights for both sides: a frozen copy of the port's msgpack
reader (flax's serialization: nil, bool, int, float, str, bin, array, map
and flax's extension types 1, ndarray, 2, complex and 3, numpy scalar)
and of its renaming of a flax parameter tree into the port model's
state_dict keys (Dense ``kernel`` (in, out) -> ``weight`` (out, in)).  The
benchmark reads the checkpoint once and hands the same arrays to the
program and to the reference."""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
          0xD9: ("text", ">B"), 0xDA: ("text", ">H"), 0xDB: ("text", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
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

    def bin(self, n):
        return bytes(self.take(n))

    def text(self, n):
        return str(self.take(n), "utf-8")

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n):
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


def _ext(code: int, data: bytes):
    if code in (1, 3):
        shape, dtype_name, buffer = decode(data)
        arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape, order="C")
        return arr if code == 1 else arr[()]
    if code == 2:
        re, im = decode(data)
        return complex(re, im)
    raise ValueError(f"unsupported msgpack extension type {code}")


def decode(data: bytes) -> Any:
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack document")
    return out


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict(path: Path) -> Dict[str, torch.Tensor]:
    """The checkpoint's parameters (``["params"]["params"]``) under the port
    model's state_dict keys, float32 CPU tensors."""
    tree = decode(Path(path).read_bytes())["params"]["params"]
    out = {}
    for path_, leaf in _flatten(tree):
        *mods, name = path_
        x = torch.from_numpy(np.array(leaf, dtype=np.float32))
        if name == "kernel":
            if len(mods) >= 2 and mods[-2] == "attention":
                raise ValueError("attention heads are not part of this benchmark's models")
            name, x = "weight", x.T
        out[".".join((*mods, name))] = x.contiguous()
    return out
