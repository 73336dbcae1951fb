"""Tracing and profiling helpers; counterpart of
``admmnet_tpu/utils/profiling.py``.

- ``trace(logdir)``: context manager around ``torch.profiler`` (CPU and, when
  available, CUDA activity) that writes a TensorBoard-loadable trace into
  ``logdir`` (``torch-tb-profiler`` reads it; it is a Chrome trace JSON);
- ``nvtx_range(name)``: an NVTX range (shows in Nsight Systems), a no-op without
  CUDA;
- ``StepTimer``: wall-clock step timing with a completion barrier
  (``torch.cuda.synchronize`` when CUDA is in use) and throughput
  accounting;
- ``timed_fetch``: time one call to completion.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace into ``logdir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


@contextlib.contextmanager
def nvtx_range(name: str):
    """An NVTX range around the block (no-op without CUDA)."""
    if not torch.cuda.is_available():
        yield
        return
    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


def _barrier(x=None) -> None:
    """Wait for the device work behind ``x`` (all of CUDA's when ``x`` is
    None)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def fetch_scalar(x) -> float:
    """Completion barrier: a host fetch of a scalar reduction of ``x``."""
    if isinstance(x, torch.Tensor):
        x = torch.sum(torch.abs(x)) if x.is_complex() else torch.sum(x)
    return float(x)


def timed_fetch(fn, *args) -> tuple:
    """(result, seconds): runs fn(*args) and waits for its first output."""
    _barrier()
    t0 = time.perf_counter()
    out = fn(*args)
    leaves = [out] if not isinstance(out, (tuple, list)) else list(out)
    fetch_scalar(leaves[0])
    return out, time.perf_counter() - t0


class StepTimer:
    """Accumulate per-step wall times; report mean/percentiles/throughput.
    ``start`` and ``stop`` wait for the CUDA device, so a step's time is
    its device work, not its launch."""

    def __init__(self, items_per_step: int = 1):
        self.items_per_step = items_per_step
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        _barrier()
        self._t0 = time.perf_counter()

    def stop(self):
        assert self._t0 is not None, "start() not called"
        _barrier()
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    @contextlib.contextmanager
    def step(self):
        self.start()
        yield
        self.stop()

    def summary(self) -> Dict[str, float]:
        import numpy as np

        t = np.asarray(self.times)
        if t.size == 0:
            return {}
        return {
            "steps": int(t.size),
            "mean_s": float(t.mean()),
            "p50_s": float(np.median(t)),
            "p95_s": float(np.percentile(t, 95)),
            "items_per_s": float(self.items_per_step / t.mean()),
        }
