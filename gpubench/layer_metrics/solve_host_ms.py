"""Host milliseconds per call of the program's fixed-budget solve (the
``solver.solve`` span), over the traced window."""

from gpubench.program_spans import ms_per


def read(ctx):
    return ms_per("solver.solve", "solver.solve")
