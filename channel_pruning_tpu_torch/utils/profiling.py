"""Forward timing and device traces (port of
channel_pruning_tpu/utils/profiling.py): the reference's `caffe time`.

On a CUDA device every time comes from CUDA events around work queued back
to back, with no host read inside the timed region; on the CPU (only when
asked for by name) from the host clock. Each result names the device and
the precision flags in force (`device.fp32_solver` turns TF32 off for
every entry point), and MFU is given against the H100's dense peak for
what the timed forward ran: 67 TFLOP/s for f32 (TF32 off); with a bf16 or
fp16 compute dtype each conv runs the JAX package's semantics on its
`ops/forward.conv_route`, at TF32's 495 TFLOP/s where the route is TF32
and at f32's elsewhere (NVIDIA's data sheet, SXM at 700 W), so the peak is
the forward's FLOPs over the least time those rates allow. No peak is
claimed for a CPU or another card: MFU is then None.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from channel_pruning_tpu_torch.ops.forward import as_dtype

H100_PEAK_FLOPS = {"f32": 67e12, "tf32": 495e12}


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record a torch.profiler trace (CPU and CUDA activity) of the
    enclosed block into `logdir` as a Chrome trace."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def conv_routes(graph, batch: int, compute_dtype, device) -> dict[str, str]:
    """Each conv's route ("tf32" or "f32", `ops/forward.conv_route`) in a
    forward of `graph` at `batch` images in `compute_dtype` on a card (the
    forward that ran decided them); empty without a dtype or a card."""
    from channel_pruning_tpu_torch.ops.forward import conv_route, conv_shapes

    cd = as_dtype(compute_dtype)
    if cd is None or torch.device(device).type != "cuda":
        return {}
    return {l.name: conv_route(x, w, geo, cd, device)
            for l, x, w, geo in conv_shapes(graph, batch)}


def peak_flops(device, compute_dtype=None, graph=None,
               batch: int = 1) -> float | None:
    """The H100's dense peak for a forward of `graph` at `batch` images, on
    an H100; else None. f32 without a compute dtype; with one, the FLOPs
    over the least time the convs' routes and f32 for the rest allow."""
    from channel_pruning_tpu_torch.graph.ir import shapes_of
    from channel_pruning_tpu_torch.utils import flops as flops_mod

    device = torch.device(device)
    if device.type != "cuda" or "H100" not in torch.cuda.get_device_name(device):
        return None
    f32 = H100_PEAK_FLOPS["f32"]
    routes = conv_routes(graph, batch, compute_dtype, device)
    if not routes:
        return f32
    total = 2.0 * flops_mod.total_flops(graph, batch=batch)
    least = total / f32
    shapes = shapes_of(graph, batch=1)
    for name, route in routes.items():
        f = 2.0 * flops_mod.layer_flops(graph, shapes, name) * batch
        least += f / H100_PEAK_FLOPS[route] - f / f32
    return total / least


def mfu(total_flops: float, seconds: float, peak: float | None) -> float | None:
    """Model FLOPs utilisation, achieved / peak; None without a peak."""
    return None if peak is None else total_flops / max(seconds, 1e-12) / peak


def precision_flags() -> dict:
    return {"tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "tf32_cudnn": torch.backends.cudnn.allow_tf32,
            "cudnn_deterministic": torch.backends.cudnn.deterministic,
            "cudnn_benchmark": torch.backends.cudnn.benchmark}


def device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _elapsed_ms(fn, n: int, device) -> float:
    """Milliseconds per call of `fn` over `n` calls queued back to back."""
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n


def _setup(graph, params, device, batch):
    from channel_pruning_tpu_torch.convert import params_on

    shape = graph.inputs[0].shape
    b = batch or shape[0]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (b,) + tuple(shape[1:])).astype(np.float32)).to(device)
    return b, x, params_on(params, device)


def _result(graph, device, b, ms, compute_dtype, **extra) -> dict:
    from channel_pruning_tpu_torch.utils import flops as flops_mod

    flops_per_image = 2.0 * flops_mod.total_flops(graph)
    routes = list(conv_routes(graph, b, compute_dtype, device).values())
    return {"device": device_name(device),
            "dtype": str(as_dtype(compute_dtype) or torch.float32).split(".")[-1],
            "conv_routes": {r: routes.count(r) for r in sorted(set(routes))},
            "flags": precision_flags(), "batch": float(b), **extra,
            "images_per_sec": float(b / (ms / 1e3)),
            "mfu": mfu(flops_per_image * b, ms / 1e3,
                       peak_flops(device, compute_dtype, graph, b))}


@torch.no_grad()
def time_forward(graph, params, *, device, batch: int | None = None,
                 iters: int = 20, warmup: int = 3, compute_dtype=None) -> dict:
    """Latency of one forward as a caller sees it: each iteration queues
    the forward and waits for it (host clock around forward + synchronize).
    mean/p50/p95 ms, images/s and MFU (FLOPs = 2 x the conv + FC multiply
    count)."""
    from channel_pruning_tpu_torch.ops.forward import run_graph

    b, x, dev = _setup(graph, params, device, batch)
    inputs = {graph.inputs[0].name: x}
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)

    def once():
        run_graph(graph, dev, inputs, compute_dtype=compute_dtype)
        sync()

    for _ in range(warmup):
        once()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    times = np.asarray(times) * 1e3
    return _result(graph, device, b, float(times.mean()), compute_dtype,
                   mean_ms=float(times.mean()),
                   p50_ms=float(np.percentile(times, 50)),
                   p95_ms=float(np.percentile(times, 95)))


@torch.no_grad()
def time_forward_device_loop(graph, params, *, device, batch: int | None = None,
                             steps: int = 20, repeats: int = 3,
                             compute_dtype=None) -> dict:
    """Device time of a forward: `steps` forwards queued back to back and
    timed with CUDA events, no host read between them; the least of
    `repeats` such windows, per step."""
    from channel_pruning_tpu_torch.ops.forward import run_graph

    b, x, dev = _setup(graph, params, device, batch)
    inputs = {graph.inputs[0].name: x}

    def fwd():
        run_graph(graph, dev, inputs, compute_dtype=compute_dtype)

    fwd()                                             # warm-up
    per_step = min(_elapsed_ms(fwd, steps, device) for _ in range(repeats))
    return _result(graph, device, b, per_step, compute_dtype,
                   steps=float(steps), device_ms_per_step=per_step)


@torch.no_grad()
def time_per_layer(graph, params, *, device, batch: int | None = None,
                   steps: int = 20, repeats: int = 2, compute_dtype=None) -> dict:
    """Per-layer forward times (the `caffe time` table): one forward pass
    snapshots each timed layer's inputs where the layer runs (before an
    in-place successor rebinds the name, and without the executor's
    dropping of dead maps), then each layer runs `steps` times back to back
    on them; the least of `repeats` windows, per call. {"layers": [{layer,
    type, ms, mults}], "sum_ms"}."""
    from channel_pruning_tpu_torch.graph.ir import LT, shapes_of
    from channel_pruning_tpu_torch.ops.forward import compute_layer
    from channel_pruning_tpu_torch.utils import flops as flops_mod

    timed = (LT.CONV, LT.FC, LT.POOL, LT.ELTWISE, LT.BN, LT.SCALE, LT.RELU,
             LT.SOFTMAX, LT.CONCAT, LT.SELECT, LT.FLATTEN)
    cd = as_dtype(compute_dtype)
    b, x, dev = _setup(graph, params, device, batch)
    env = {graph.inputs[0].name: x}
    layer_inputs = {}
    for l in graph.layers:
        if l.type in timed and all(bt in env for bt in l.bottoms):
            layer_inputs[l.name] = {bt: env[bt] for bt in l.bottoms}
        compute_layer(l, env, dev, compute_dtype=cd)
    del env

    shapes = shapes_of(graph, batch=1)
    rows = []
    for l in graph.layers:
        if l.name not in layer_inputs:
            continue
        ins = layer_inputs.pop(l.name)

        def run(l=l, ins=ins):
            compute_layer(l, dict(ins), dev, compute_dtype=cd)

        run()                                         # warm-up
        ms = min(_elapsed_ms(run, steps, device) for _ in range(repeats))
        rows.append({"layer": l.name, "type": l.type, "ms": ms,
                     "mults": flops_mod.layer_flops(graph, shapes, l.name) * b})
    return {"device": device_name(device), "flags": precision_flags(),
            "batch": float(b), "steps": float(steps), "layers": rows,
            "sum_ms": float(sum(r["ms"] for r in rows))}
