"""Share of the eigensolver's roofline in the eigh GLayers' forward: the
fixed count of an eigensolve of the batch (``flops/``: 36 m^3 operations a
matrix; M in, w and V out) times the GLayer spans of the traced window, at
the card's bf16 and HBM peaks, over the device time of the operations the
trace names after the program's eigh kernel (``eigh_jacobi``), in %.  None
where the trace holds no such operation."""

from gpubench.harness import roofline_pct

KERNEL = "eigh_jacobi"


def read(ctx):
    n = ctx.trace.span_count.get("glayer", 0)
    t = sum(s for name, s in ctx.trace.device_ops if KERNEL in name)
    if not n or not t or "eigh" not in ctx.per_call:
        return None
    flops, nbytes = ctx.per_call["eigh"]
    return roofline_pct(n * flops, n * nbytes, t)
