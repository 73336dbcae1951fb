"""Minibatch pipeline with a native (C++) shuffle and gather and a
background prefetch thread.

Counterpart of ``admmnet_tpu/data/loader.py``.  ``PrefetchLoader``
assembles shuffled minibatches in C++ worker threads (the GIL released by
ctypes) one batch ahead of consumption, so the host's batch preparation
overlaps the device's step.  The shuffle is the JAX package's native one
bit for bit (Fisher-Yates with SplitMix64 seeded from ``seed``), so the
two trainers draw the same minibatches.

The library is the port's own copy of the source
(``admmnet_tpu_torch/native/fastloader.cpp``), compiled by ``g++`` at first
use into ``build/native/`` at the repository root, named by a hash of the
source.  Where it does not build (no toolchain), ``native_available()`` is
False and the trainer takes the numpy ``iterate_batches`` instead, as the
JAX trainer does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "fastloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
N_THREADS = 4  # C++ gather threads
PREFETCH = 2  # PrefetchLoader's batches ready ahead of the consumer

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libfastloader_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile the source unless the library for its hash exists; two
    processes building at once each write their own file and rename it
    into place."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                        str(SOURCE), "-lpthread"], check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def ensure_built() -> bool:
    """Build and load the native library if needed; return availability."""
    global _lib
    with _lock:
        if _lib is not None:
            return True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.CalledProcessError):
            return False
        lib.fl_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.fl_gather_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ]
        lib.fl_shuffle_indices.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64]
        _lib = lib
    return True


def native_available() -> bool:
    return ensure_built()


def _as2d(v: np.ndarray) -> np.ndarray:
    return v.reshape(v.shape[0], -1)


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Native dst[i] = src[idx[i]] for a float32 2-D array."""
    if not ensure_built():
        raise RuntimeError("native loader unavailable")
    src = np.ascontiguousarray(_as2d(src), np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    out = np.empty((idx.shape[0], src.shape[1]), np.float32)
    _lib.fl_gather_rows(src.ctypes.data, src.shape[0], src.shape[1], idx.ctypes.data,
                        idx.shape[0], out.ctypes.data, N_THREADS)
    return out


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    """Deterministic native Fisher-Yates permutation of [0, n)."""
    if not ensure_built():
        raise RuntimeError("native loader unavailable")
    idx = np.empty(n, np.int64)
    _lib.fl_shuffle_indices(idx.ctypes.data, n, ctypes.c_uint64(seed))
    return idx


class _SplitComplex:
    """A complex or real array viewed as a float32 (rows, cols) plane for
    gathering."""

    def __init__(self, v: np.ndarray):
        self.complex = np.iscomplexobj(v)
        self.shape = v.shape
        if self.complex:
            c = np.ascontiguousarray(v.astype(np.complex64))
            self.plane = c.view(np.float32).reshape(v.shape[0], -1)
        else:
            self.plane = np.ascontiguousarray(_as2d(v).astype(np.float32))

    def assemble(self, gathered: np.ndarray, n: int) -> np.ndarray:
        out = gathered.view(np.complex64) if self.complex else gathered
        return out.reshape(n, *self.shape[1:])


class PrefetchLoader:
    """Shuffled minibatches by the native gather (``N_THREADS`` C++ threads),
    up to ``PREFETCH`` batches ahead in a background thread.  Float and
    complex arrays go through the C++ gather; integer arrays (``L_true``)
    are indexed in numpy.  Yields dicts of numpy arrays, every row once, as
    ``iterate_batches`` does; ``drop_remainder`` leaves out the last, short
    minibatch."""

    def __init__(self, data: Dict[str, np.ndarray], batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_remainder: bool = False):
        if not ensure_built():
            raise RuntimeError("native loader unavailable; use iterate_batches")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self._float_keys = [k for k, v in data.items() if v.dtype.kind in "fc"]
        self._other = {k: v for k, v in data.items() if v.dtype.kind not in "fc"}
        self._views = {k: _SplitComplex(data[k]) for k in self._float_keys}
        self.n = next(iter(data.values())).shape[0]

    def _assemble(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        n = idx.shape[0]
        planes = [self._views[k].plane for k in self._float_keys]
        outs = [np.empty((n, p.shape[1]), np.float32) for p in planes]
        src_ptrs = (ctypes.c_void_p * len(planes))(*[p.ctypes.data for p in planes])
        dst_ptrs = (ctypes.c_void_p * len(outs))(*[o.ctypes.data for o in outs])
        colss = np.asarray([p.shape[1] for p in planes], np.int64)
        idx = np.ascontiguousarray(idx, np.int64)
        _lib.fl_gather_batch(src_ptrs, dst_ptrs, colss.ctypes.data, len(planes),
                             idx.ctypes.data, n, N_THREADS)
        batch = {k: self._views[k].assemble(o, n) for k, o in zip(self._float_keys, outs)}
        for k, v in self._other.items():
            batch[k] = v[idx]
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = (shuffle_indices(self.n, self.seed) if self.shuffle
                 else np.arange(self.n, dtype=np.int64))
        stop = self.n - (self.n % self.batch_size) if self.drop_remainder else self.n
        starts = list(range(0, stop, self.batch_size))
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)

        def producer():
            for s in starts:
                q.put(self._assemble(order[s:s + self.batch_size]))
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            yield item
        t.join()

    def __len__(self) -> int:
        if self.drop_remainder:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size
