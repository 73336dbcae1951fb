"""Host milliseconds in the program's eigendecomposition backward (the
``models.eigh_bwd`` span: M_bar = V diag(w_bar) V^H) per eigh GLayer
backward (``models.glayer_bwd``), over the traced window."""

from gpubench.program_spans import ms_per


def read(ctx):
    return ms_per("models.eigh_bwd", "models.glayer_bwd")
