"""Host milliseconds in the program's eigendecomposition (the
``models.eigh`` span) per eigh GLayer forward (``models.glayer``), over the
traced window."""

from gpubench.program_spans import ms_per


def read(ctx):
    return ms_per("models.eigh", "models.glayer")
