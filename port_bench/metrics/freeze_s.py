"""freeze_s: host seconds around `sampler.freeze`, the mean over the
window's jobs."""


def read(ctx):
    return ctx.span_mean("freeze")
