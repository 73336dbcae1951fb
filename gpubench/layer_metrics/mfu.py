"""The whole call's share of the card's peak: the operations of every call
in the traced window (``flops/``: solve and peak search, trunk and head, or
a training step's forward, backward and head) over the window's length
times 989 TFLOP/s, in %."""


def read(ctx):
    n = ctx.trace.span_count.get("call", 0)
    if not n or ctx.trace.window_s <= 0:
        return None
    return 100.0 * n * ctx.per_call["call"][0] / (ctx.trace.window_s * ctx.peak_flops)
