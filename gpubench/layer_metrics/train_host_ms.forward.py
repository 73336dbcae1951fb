"""Host milliseconds per training step (the program's ``train.step`` span)
spent in its ``train.forward`` span, over the traced window."""

from gpubench.program_spans import ms_per


def read(ctx):
    return ms_per("train.forward", "train.step")
