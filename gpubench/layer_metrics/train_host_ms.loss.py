"""Host milliseconds per training step (the program's ``train.step`` span)
spent in its ``train.loss`` span, over the traced window."""

from gpubench.program_spans import ms_per


def read(ctx):
    return ms_per("train.loss", "train.step")
