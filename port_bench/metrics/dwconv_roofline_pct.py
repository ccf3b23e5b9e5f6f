"""dwconv_roofline_pct: the least time of a job's depthwise convs over
their device time (`dwconv_ms`), in percent. A depthwise conv is a conv
whose group is above 1 and equals its input channels. Its least time over
n images is the larger of its f32 bytes (input and output of each image,
and the weights and bias once) at HBM bandwidth and its operations (2 x
its multiplies, `shapes.conv_mults`, each image) at the f32 peak. A job
runs, as `mfu_pct` counts its convs:
  * the freeze: each depthwise conv of the original network over the
    calibration images;
  * the replays: each depthwise conv of the compressed network that the
    last solved layer's input depends on, once over the images."""
import math

from port_bench import shapes
from port_bench.metrics import dwconv_ms


def depthwise_convs(layers: list[dict], one: tuple[int, ...]) -> list[str]:
    """Names of the depthwise convs of a plain layer list."""
    env = shapes.tensor_shapes(layers, one)
    out = []
    for l in layers:
        if l["type"] != "Convolution":
            continue
        group = shapes.conv_geometry(l["attrs"])["group"]
        if group > 1 and group == env[l["bottoms"][0]][1]:
            out.append(l["name"])
    return out


def least_seconds(layers: list[dict], one: tuple[int, ...], n_img: int,
                  names=None) -> float:
    """The least time of the depthwise convs of `layers` (those of `names`
    alone, when given) over `n_img` images of shape `one` (batch 1)."""
    env = shapes.tensor_shapes(layers, one)
    mults = shapes.conv_mults(layers, one)
    by = {l["name"]: l for l in layers}
    t = 0.0
    for name in depthwise_convs(layers, one):
        if names is not None and name not in names:
            continue
        l = by[name]
        g = shapes.conv_geometry(l["attrs"])
        n_in = math.prod(env[l["bottoms"][0]])
        n_out = math.prod(env[l["tops"][0]])
        c_out = int(l["attrs"]["num_output"])
        params = c_out * g["kh"] * g["kw"] + c_out
        nbytes = 4 * (n_img * (n_in + n_out) + params)
        flops = 2.0 * mults[name] * n_img
        t += max(nbytes / shapes.HBM_BYTES_PER_S,
                 flops / shapes.PEAK_FLOPS["float32"])
    return t


def job_least_seconds(ctx) -> float:
    from port_bench.checks import solved_layers
    cfg = ctx.cell.config
    n_img = int(cfg["n_batches"]) * int(cfg["batch_size"])
    size = int(cfg["image_size"])
    one = (1, 3, size, size)
    t = least_seconds(ctx.orig, one, n_img)
    items = solved_layers(ctx.orig, ctx.cell.traffic)
    last = next((l for l in ctx.out if items
                 and l["name"] == items[-1]["consumer"]), None)
    if last is not None:
        before = shapes.ancestors(ctx.out, [last["bottoms"][0]])
        t += least_seconds(ctx.out, one, n_img, before)
    return t


def read(ctx):
    if ctx.trace is None or not ctx.window_jobs:
        return None
    measured = ctx.trace.seconds_of(dwconv_ms.KERNEL) / len(ctx.window_jobs)
    least = job_least_seconds(ctx)
    if measured <= 0 or least <= 0:
        return None
    return 100.0 * least / measured
