"""Share of the GLayers' roofline in the training step: the Clenshaw
operations and bytes of each GLayer forward (K5's) and backward (K6's)
(``flops/``) at the card's bf16 and HBM peaks, over the device time of the
operations launched inside the GLayer forward and backward hooks' spans,
in %."""

from gpubench.harness import roofline_pct


def read(ctx):
    tr = ctx.trace
    nf, nb = tr.span_count.get("glayer", 0), tr.span_count.get("glayer_bwd", 0)
    t = tr.span_device_s.get("glayer", 0.0) + tr.span_device_s.get("glayer_bwd", 0.0)
    if not nf or not nb or not t or "glayer_bwd" not in ctx.per_call:
        return None
    (ff, fb), (bf, bb) = ctx.per_call["glayer"], ctx.per_call["glayer_bwd"]
    return roofline_pct(nf * ff + nb * bf, nf * fb + nb * bb, t)
