"""prune_pass_s: host seconds around `c3.solve_prune` (the pipelined prune
pass), the mean over the window's jobs."""


def read(ctx):
    return ctx.span_mean("prune_pass")
