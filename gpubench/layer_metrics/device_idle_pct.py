"""Share of the traced window in which no operation ran on the device:
100 (1 - the union of the device operations' intervals / the window)."""


def read(ctx):
    tr = ctx.trace
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr.window_s > 0 else None
