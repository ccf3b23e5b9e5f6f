"""idle_pct: the share of the traced window in which no kernel, copy or
set ran on the device (the union of their intervals, so streams that
overlap count once), in percent."""


def read(ctx):
    if ctx.trace is None:
        return None
    window = ctx.trace.hi - ctx.trace.lo
    return 100.0 * (1.0 - ctx.trace.busy_seconds() / window)
