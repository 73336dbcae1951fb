"""Host milliseconds per batch that the consumer of the program's loader
waited for it (the ``loader.wait`` span), over the traced window."""

from gpubench.program_spans import ms_per


def read(ctx):
    return ms_per("loader.wait", "loader.wait")
