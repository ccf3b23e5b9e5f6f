"""cd_roofline_pct: the least time of the window's CD searches over the
device time of the CD kernels, in percent. A search's least time is that
of each grid it solved (`shapes.cd_grid_least_seconds`: its c x c Gram
and right-hand side read once and its coefficient vectors written once at
HBM bandwidth, or one sweep an alpha at the f32 peak, whichever is
longer), with c the layer's input channels and the grids as the job
reports them: the work the problem needs, whatever implements it."""
from port_bench import shapes
from port_bench.metrics import cd_ms


def read(ctx):
    if ctx.trace is None:
        return None
    measured = ctx.trace.seconds_of(cd_ms.KERNEL)
    alphas = int(ctx.setting("lasso.grid_size", "32"))
    least = sum(g * shapes.cd_grid_least_seconds(c, alphas)
                for job in ctx.cd_searches for c, g in job)
    if measured <= 0 or least <= 0:
        return None
    return 100.0 * least / measured
