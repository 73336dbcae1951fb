"""Tracing and profiling helpers; counterpart of
``admmnet_tpu/utils/profiling.py``.

- ``span(name)``: the program's one range helper, a context manager placed
  where the work happens (``begin(name)`` / ``end(token)`` where a
  ``with`` block does not fit).  While a ``torch.profiler`` records, it
  opens a ``record_function`` range named ``admmnet:<name>`` (in the same
  Kineto trace as the device's kernels, on one clock) and adds its
  host-clock seconds and a count to an in-memory registry; otherwise it
  costs one ``torch.autograd._profiler_enabled()`` check and records
  nothing;
- ``backward_span(name, x)``: a span around the backward of the work
  between ``x`` and the output handed to the ``close`` it returns (two
  tensor hooks, set only while a profiler records);
- ``snapshot()``: the registry, ``{name: {"count", "host_s"}}`` of the
  newest profiling session, beside every kernel's launch count
  (``launches.<kernel>: {"count"}``);
- ``LaunchCounter``: a kernel's launch count, one per kernel module;
- ``trace(logdir)``: context manager around ``torch.profiler`` (CPU and, when
  available, CUDA activity) that writes a TensorBoard-loadable trace into
  ``logdir`` (``torch-tb-profiler`` reads it; it is a Chrome trace JSON);
- ``StepTimer``: wall-clock step timing with a completion barrier
  (``torch.cuda.synchronize`` when CUDA is in use) and throughput
  accounting;
- ``timed_fetch``: time one call to completion.

The spans the program opens, by where they are:

- ``train.step``, ``train.forward``, ``train.loss``, ``train.backward``
  (the backward and the zero-fill of unused leaves), ``train.clip``,
  ``train.optimizer``, ``eval.step`` (with its own ``eval.forward`` and
  ``eval.loss``): ``train/trainer.py``'s ``build_steps``;
- ``loader.wait``: ``data/loader.py``'s ``PrefetchLoader``, the consumer
  waiting for one batch;
- ``peaks.search``: ``peaks/search.py``'s ``find_peaks``, around the one
  launch of the peak-search kernel on the card; on the CPU, around the
  plain version's ``peaks.coarse`` (the axes and the coarse spectrum),
  ``peaks.select`` (local maxima, top-k, the seeds) and ``peaks.refine``
  (the zoom and the final sort);
- ``solver.solve``: ``solver/admm.py``'s ``admm_solve_fixed``;
- ``models.glayer``: ``GLayer.forward``; ``models.glayer_bwd``: the
  Clenshaw backward that launches K6 (``kernels/cheb_filter.py``), or the
  whole backward of an eigh GLayer (``backward_span``: the rebuild's
  product, the filter and the eigendecomposition's backward);
  ``models.eigh``: the eigh GLayer's eigendecomposition inside
  ``models.glayer`` (on the card the Jacobi kernel, ``launches.eigh``);
  ``models.eigh_bwd``: its backward, M_bar = V diag(w_bar) V^H
  (``kernels/eigh.py``), inside ``models.glayer_bwd``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import torch

SPAN_PREFIX = "admmnet:"

_profiler_enabled = torch.autograd._profiler_enabled
_record_function = torch.autograd.profiler.record_function


class _Registry:
    """Count and host seconds of each span name, of the newest profiling
    session.  ``stale`` is set by a span that saw no profiler: the next span
    opened under one starts the registry afresh.  Spans may close on the
    autograd engine's threads (a backward), hence the lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans: Dict[str, list] = {}  # name: [count, host seconds]
        self.stale = True


_REGISTRY = _Registry()
_COUNTERS: Dict[str, "LaunchCounter"] = {}
_OFF = contextlib.nullcontext()


class LaunchCounter:
    """Plain count of a kernel's launches (one per launched batch), reported
    by ``snapshot`` under ``launches.<kernel>``."""

    def __init__(self, kernel: str):
        self.count = 0
        _COUNTERS[kernel] = self

    def reset(self):
        self.count = 0


def _open(name: str):
    reg = _REGISTRY
    with reg.lock:
        if reg.stale:
            reg.spans.clear()
            reg.stale = False
    rf = _record_function(SPAN_PREFIX + name)
    rf.__enter__()
    return name, rf, time.perf_counter()


def _close(token) -> None:
    name, rf, t0 = token
    dt = time.perf_counter() - t0
    rf.__exit__(None, None, None)
    reg = _REGISTRY
    with reg.lock:
        entry = reg.spans.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += dt


class _Span:
    __slots__ = ("name", "token")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.token = _open(self.name)

    def __exit__(self, *exc):
        _close(self.token)


def span(name: str):
    """Context manager: the block as span ``name`` (module docstring)."""
    if not _profiler_enabled():
        _REGISTRY.stale = True
        return _OFF
    return _Span(name)


def begin(name: str):
    """Open span ``name``; returns the token to hand to ``end`` (None when
    no profiler records)."""
    if not _profiler_enabled():
        _REGISTRY.stale = True
        return None
    return _open(name)


def end(token) -> None:
    """Close the span ``begin`` opened."""
    if token is not None:
        _close(token)


def _same(y):
    return y


def backward_span(name: str, x: torch.Tensor):
    """``close``: autograd runs the backward of the work from ``x`` to the
    ``y`` of ``close(y)`` inside span ``name``, opened by a hook on ``y`` as
    its gradient arrives and closed by one on ``x`` as its gradient is
    whole.  Only while a profiler records and ``x`` needs a gradient;
    otherwise ``close`` is the identity and no hook is set."""
    if not (_profiler_enabled() and x.requires_grad and torch.is_grad_enabled()):
        return _same
    token = [None]

    def opens(g):
        token[0] = begin(name)

    def closes(g):
        end(token[0])
        token[0] = None

    x.register_hook(closes)

    def close(y):
        y.register_hook(opens)
        return y

    return close


def snapshot() -> Dict[str, Dict[str, float]]:
    """``{name: {"count", "host_s"}}`` of the spans of the newest profiling
    session, and ``{"launches.<kernel>": {"count"}}`` of every kernel."""
    with _REGISTRY.lock:
        out = {k: {"count": c, "host_s": s} for k, (c, s) in _REGISTRY.spans.items()}
    out.update({f"launches.{k}": {"count": c.count} for k, c in _COUNTERS.items()})
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace into ``logdir``; the span registry
    starts afresh with it."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    _REGISTRY.stale = True
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


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
