"""Median host-clock milliseconds of the traced run's requests that ran
after the profiler stopped (all of them if it ran to the end)."""

import statistics


def read(ctx):
    rec = ctx.record
    calls = rec.call_s[rec.traced_calls:] or rec.call_s
    return 1e3 * statistics.median(calls) if calls else None
