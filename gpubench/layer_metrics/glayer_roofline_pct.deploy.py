"""Share of the GLayers' roofline in the learned forward: the Clenshaw
operations and bytes of each GLayer forward (``flops/``, K4's) at the
card's bf16 and HBM peaks, over the device time of the operations launched
inside the GLayer forward hooks' spans, in %."""

from gpubench.harness import roofline_pct


def read(ctx):
    n = ctx.trace.span_count.get("glayer", 0)
    t = ctx.trace.span_device_s.get("glayer")
    if not n or not t or "glayer" not in ctx.per_call:
        return None
    flops, nbytes = ctx.per_call["glayer"]
    return roofline_pct(n * flops, n * nbytes, t)
