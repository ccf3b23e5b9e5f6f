"""cd_ms: device milliseconds of the CD search kernels (K1 and K2, every
kernel whose name holds `lasso_cd`) a job, from the traced window."""

KERNEL = "lasso_cd"


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.seconds_of(KERNEL)
    return 1e3 * s / len(ctx.window_jobs) if s > 0 else None
