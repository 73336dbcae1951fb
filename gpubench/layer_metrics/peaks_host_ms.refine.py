"""Host milliseconds per peak search (the program's ``peaks.search`` span)
spent in its ``peaks.refine`` span, over the traced window."""

from gpubench.program_spans import ms_per


def read(ctx):
    return ms_per("peaks.refine", "peaks.search")
