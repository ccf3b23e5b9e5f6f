"""mfu_pct: the least time a job's work allows at the H100's peaks over the
traced run's job time, in percent. The work, counted from shapes by
`port_bench.shapes`:
  * the freeze: every conv of the original network over the calibration
    images, at the f32 peak (the ground truth is f32);
  * the replays: each conv of the compressed network that the last solved
    layer's input depends on, once over the images, at the peak of the
    replay precision the traffic states (bf16 operands: the bf16 peak);
  * each solved layer's least squares (`shapes.lstsq_flops`) over its
    sampled rows and its kept c * kh * kw inputs, at the f32 peak.
Every part is a least amount, so the share stays a bound when a program
changes how it does the work."""
from port_bench import shapes


def _layer(layers, name):
    return next((l for l in layers if l["name"] == name), None)


def least_seconds(ctx) -> float:
    cfg = ctx.cell.config
    n_img = int(cfg["n_batches"]) * int(cfg["batch_size"])
    rows = n_img * int(cfg["n_points_per_layer"])
    size = int(cfg["image_size"])
    one = (1, 3, size, size)
    f32 = shapes.PEAK_FLOPS["float32"]
    t = 2.0 * sum(shapes.conv_mults(ctx.orig, one).values()) * n_img / f32
    replay_peak = shapes.PEAK_FLOPS.get(ctx.setting("solve.dtype", "float32"), f32)
    from port_bench.checks import solved_layers
    items = solved_layers(ctx.orig, ctx.cell.traffic)
    if not items:
        return t
    out = ctx.out
    shapes_out = shapes.tensor_shapes(out, one)
    solve = 0.0
    for it in items:
        W = _layer(out, it["consumer"])
        g = shapes.conv_geometry(W["attrs"])
        kept = shapes_out[W["bottoms"][0]][1]
        solve += shapes.lstsq_flops(rows, kept * g["kh"] * g["kw"],
                                    int(W["attrs"]["num_output"]))
    last = _layer(out, items[-1]["consumer"])
    if last is None:
        return t
    before = shapes.ancestors(out, [last["bottoms"][0]])
    mults = shapes.conv_mults(out, one)
    t += 2.0 * sum(v for k, v in mults.items() if k in before) * n_img / replay_peak
    return t + solve / f32


def read(ctx):
    if ctx.trace is None or not ctx.window_jobs:
        return None
    return 100.0 * least_seconds(ctx) / ctx.job_s
