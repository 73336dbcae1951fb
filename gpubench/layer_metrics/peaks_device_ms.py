"""Device milliseconds per call (a batch or a request) of the operations
launched in the traced window's ``peaks`` spans (the peak search)."""


def read(ctx):
    n = ctx.trace.span_count.get("peaks", 0)
    t = ctx.trace.span_device_s.get("peaks")
    return 1e3 * t / n if n and t else None
