"""Failure detection and recovery for long-running device jobs: the port's
copy of the JAX package's ``utils/retry.py`` (SURVEY.md section 5: the
reference's only failure handling is a solver status print and a fallback,
admm.py:144-145,210-213).

``device_retry`` wraps a device-touching callable with detection and
exponential-backoff retries, so epoch-scale jobs (dataset labelling,
training loops) survive a transient loss of the device; with the trainer's
checkpoint/resume, a hard failure costs at most one epoch.  A failure is
retried when its message carries one of the markers below, which are the
JAX package's (the TPU runtime's transient payloads: a worker crash or
restart, a dropped tunnel); any other error is raised at once.  Wrap only
work that a retry repeats without side effects.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Tuple

RETRYABLE_MARKERS: Tuple[str, ...] = (
    "UNAVAILABLE",
    "worker process crashed",
    "DEADLINE_EXCEEDED",
    "INTERNAL",
    "Socket closed",
)

# FAILED_PRECONDITION alone is a status class that also covers persistent
# programming errors (deleted or donated buffers, a device ordinal
# mismatch): retrying those burns the whole backoff budget (~12.5 min)
# before the error surfaces.  Only its co-occurrence with the "TPU backend
# error" payload, the observed transient form, is retried.
_PRECONDITION_MARKERS: Tuple[str, ...] = ("FAILED_PRECONDITION", "FailedPrecondition")


def is_retryable(exc: BaseException) -> bool:
    """Whether ``exc`` looks like a transient loss of the device."""
    msg = str(exc)
    if any(m in msg for m in RETRYABLE_MARKERS):
        return True
    return "TPU backend error" in msg and any(m in msg for m in _PRECONDITION_MARKERS)


def device_retry(
    fn: Callable = None,
    *,
    attempts: int = 3,
    cooldown_s: float = 300.0,
    backoff: float = 1.5,
    log_fn: Callable[[str], None] = print,
):
    """Decorator or wrapper retrying ``fn`` on transient device failures:
    up to ``attempts`` calls, sleeping ``cooldown_s`` before the first
    retry and ``backoff`` times longer before each next one."""

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            delay = cooldown_s
            for attempt in range(attempts):
                try:
                    return f(*args, **kwargs)
                except Exception as exc:  # noqa: BLE001 - filtered below
                    if attempt + 1 >= attempts or not is_retryable(exc):
                        raise
                    log_fn(
                        f"device failure ({type(exc).__name__}): retrying in "
                        f"{delay:.0f}s ({attempt + 1}/{attempts - 1} retries "
                        f"used): {str(exc)[:120]}"
                    )
                    time.sleep(delay)
                    delay *= backoff
            raise RuntimeError("unreachable")

        return wrapper

    if fn is not None:
        return deco(fn)
    return deco
