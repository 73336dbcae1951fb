"""Share of the solve's roofline: the operations and bytes of the solves
launched in the traced window's ``solve`` spans (``flops/``) at the card's
bf16 and HBM peaks, over the device time of those spans, in %."""

from gpubench.harness import roofline_pct


def read(ctx):
    t = ctx.trace.span_device_s.get("solve")
    n = ctx.trace.span_count.get("solve", 0)
    if not t or not n or "solve" not in ctx.per_call:
        return None
    flops, nbytes = ctx.per_call["solve"]
    return roofline_pct(n * flops, n * nbytes, t)
