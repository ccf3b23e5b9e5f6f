"""job_s: the measured window over the jobs it finished, the job in flight
at the deadline included: the wall time a user waits for one compression,
from calibration images on the host to the compressed model on the host."""


def read(ctx):
    return ctx.job_s if ctx.window_jobs else None
