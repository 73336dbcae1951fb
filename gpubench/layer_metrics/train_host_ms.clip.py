"""Host milliseconds per training step (the program's ``train.step`` span)
spent in its ``train.clip`` span, over the traced window."""

from gpubench.program_spans import ms_per


def read(ctx):
    return ms_per("train.clip", "train.step")
