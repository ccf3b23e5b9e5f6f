"""setup_s: from the start of the process to the first timed job: imports,
the CD kernels' load (or build), the weights, calibration sets and
held-out batch made from the seed, and one whole warm job."""


def read(ctx):
    return ctx.setup_s
