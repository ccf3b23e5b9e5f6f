"""dwconv_ms: device milliseconds of PyTorch's depthwise conv kernels
(every kernel whose name holds `conv_depthwise2d`, the kernel an f32
depthwise conv runs on the card) a job, from the traced window: the
depthwise convs of the freeze and of the replays."""

KERNEL = "conv_depthwise2d"


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.seconds_of(KERNEL)
    return 1e3 * s / len(ctx.window_jobs) if s > 0 else None
