"""Graph executor (port of channel_pruning_tpu/ops/forward.py).

Interprets the `Graph` IR (graph/ir.py) eagerly in NCHW with Caffe-layout
parameters (conv W (O, I/g, kh, kw), FC W (O, CHW)). `capture` returns
interior tensors alongside the outputs; `capture_transforms` are applied
when each tensor is produced, so only the transformed (sampled) value stays
alive. Gradients flow only with `train=True`; every other pass (the
freeze, the solver's replays, eval) runs under no_grad. Train-mode dropout
draws its masks from a `torch.Generator` (the identity without one, as the
JAX package is without an rng); `compute_dtype` runs the convs in a lower
precision with f32 outputs. With tracing on (`utils/trace`), each depthwise
conv (group equal to its input channels, above 1) runs inside a span
`forward.depthwise` named after the conv, in the freeze and the replays
alike.
"""
from __future__ import annotations

import functools
import zlib
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from channel_pruning_tpu_torch.graph.ir import Graph, Layer, LT, shapes_of
from channel_pruning_tpu_torch.utils import trace

Params = Mapping[str, Mapping[str, torch.Tensor]]

_DATA_TYPES = (LT.DATA, LT.IMAGE_DATA, LT.MEMORY_DATA, LT.INPUT)


def _channel(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over an NCHW (or NC) tensor."""
    return v.reshape((1, -1) + (1,) * (ndim - 2)) if ndim > 2 else v


def _pool(x: torch.Tensor, l: Layer) -> torch.Tensor:
    """Caffe ceil-mode pooling: explicit right/bottom padding realises the
    ceil window walk; average pooling divides by the in-image element count
    of each window (not torch's count_include_pad)."""
    if l.attr("global_pooling", False):
        return x.mean(dim=(2, 3), keepdim=True)
    k = int(l.attr("kernel_size"))
    s = int(l.attr("stride", 1))
    p = int(l.attr("pad", 0))
    h, w = x.shape[2], x.shape[3]
    if l.attr("ceil_mode", True):
        oh = -(-(h + 2 * p - k) // s) + 1
        ow = -(-(w + 2 * p - k) // s) + 1
        if p > 0:
            if (oh - 1) * s >= h + p:
                oh -= 1
            if (ow - 1) * s >= w + p:
                ow -= 1
    else:
        oh = (h + 2 * p - k) // s + 1
        ow = (w + 2 * p - k) // s + 1
    pads = (p, max(0, (ow - 1) * s + k - w - p),
            p, max(0, (oh - 1) * s + k - h - p))
    mode = l.attr("pool", "max")
    if mode == "max":
        return F.max_pool2d(F.pad(x, pads, value=float("-inf")), k, s)
    if mode == "ave":
        summed = F.avg_pool2d(F.pad(x, pads), k, s, divisor_override=1)
        ones = torch.ones((1, 1, h, w), dtype=x.dtype, device=x.device)
        counts = F.avg_pool2d(F.pad(ones, pads), k, s, divisor_override=1)
        return summed / counts
    raise NotImplementedError(f"pool mode {mode}")


def _batchnorm(x: torch.Tensor, p: Mapping[str, torch.Tensor],
               eps: float) -> torch.Tensor:
    """Caffe BatchNorm inference: blobs = (mean*f, var*f, f)."""
    factor = p.get("factor")
    if factor is not None:
        scale = torch.where(factor == 0, torch.ones_like(factor), 1.0 / factor)
        mean, var = p["mean"] * scale, p["var"] * scale
    else:
        mean, var = p["mean"], p["var"]
    return (x - _channel(mean, x.ndim)) * torch.rsqrt(_channel(var, x.ndim) + eps)


def as_dtype(dtype) -> torch.dtype | None:
    """None, a torch dtype, or its name ("bfloat16", "float16", ...)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


# compute dtypes whose every value TF32 holds exactly: bf16's 8 and fp16's
# 11 significand bits against TF32's 11, inside f32's exponent range
_TF32_EXACT = (torch.bfloat16, torch.float16)
EXACT_RTOL = 1e-5        # max|TF32 conv - f32 conv| over max|f32 conv|
_ROUTES: dict[tuple, str] = {}


def _conv_kw(geo: dict[str, int]) -> dict:
    return dict(stride=(geo["sh"], geo["sw"]), padding=(geo["ph"], geo["pw"]),
                groups=geo["group"])


def tf32_convs(allow: bool = True):
    """cuDNN's TF32 convs on (or off) inside the block only, with the
    deterministic heuristic choice of algorithm that `device.fp32_solver`
    sets; every flag is restored on exit."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=allow)


def _route_key(x_shape, w_shape, geo, dtype, device) -> tuple:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:      # "cuda" is "cuda:<current>"
        dev = torch.device("cuda", torch.cuda.current_device())
    return (tuple(int(d) for d in x_shape), tuple(int(d) for d in w_shape),
            tuple(sorted(geo.items())), dtype, dev)


def conv_route(x_shape, w_shape, geo: dict[str, int], dtype: torch.dtype,
               device) -> str:
    """How `_conv2d` runs a conv of operands rounded to `dtype` on a card:
    "tf32" where cuDNN's TF32 conv at this shape equals the f32 conv
    (TF32 off) within EXACT_RTOL of its largest |value|, else "f32".
    Products of such operands are exact in TF32 and summed in f32, unless
    the algorithm cuDNN picks transforms the operands first (Winograd,
    FFT). Decided once a shape, dtype and device in a process, on seeded
    random operands at the real shape (the algorithm depends on it); a
    shape that leaves TF32 is printed."""
    key = _route_key(x_shape, w_shape, geo, dtype, device)
    route = _ROUTES.get(key)
    if route is not None:
        return route
    route, device = "f32", key[-1]
    if dtype in _TF32_EXACT:
        gen = torch.Generator(device=device).manual_seed(0)
        x = torch.randn(key[0], generator=gen, device=device).to(dtype).float()
        w = torch.randn(key[1], generator=gen, device=device).to(dtype).float()
        with torch.no_grad():
            with tf32_convs(False):
                ref = F.conv2d(x, w, None, **_conv_kw(geo))
            with tf32_convs():
                got = F.conv2d(x, w, None, **_conv_kw(geo))
        err = float((got - ref).abs().max() / ref.abs().max())
        del x, w, got, ref
        if err <= EXACT_RTOL:
            route = "tf32"
        else:
            print(f"[conv] x {key[0]} w {key[1]} {geo}: the TF32 conv of "
                  f"{str(dtype).split('.')[-1]} operands is off the f32 "
                  f"conv by {err:.2e} of its max; this shape runs the f32 "
                  "conv", flush=True)
    _ROUTES[key] = route
    return route


def conv_shapes(graph: Graph, batch: int):
    """(layer, x shape, W shape, geometry) of every conv at `batch` images."""
    shapes = shapes_of(graph, batch=batch)
    out = []
    for l in graph.layers:
        if l.type == LT.CONV:
            geo = l.conv_geometry()
            x = shapes[l.bottoms[0]]
            out.append((l, x, (int(l.attr("num_output")), x[1] // geo["group"],
                               geo["kh"], geo["kw"]), geo))
    return out


def settle_conv_routes(graph: Graph, batch: int, compute_dtype, device) -> None:
    """Decide `conv_route` for every conv of `graph` at `batch` images now
    (each decision reads the card once), so that a pass that must not wait
    on the host (the pipelined solve) finds them made."""
    cd = as_dtype(compute_dtype)
    if cd is None or torch.device(device).type != "cuda":
        return
    for _, x, w, geo in conv_shapes(graph, batch):
        conv_route(x, w, geo, cd, device)


def _conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
            geo: dict[str, int], compute_dtype: torch.dtype | None) -> torch.Tensor:
    """With `compute_dtype`, the JAX package's conv
    (channel_pruning_tpu/ops/forward.py:30-47): x and W rounded to it, the
    products and their sums in f32, an f32 output, the bias added in f32.
    On the CPU an f32 conv of the rounded operands; on a card the same
    through cuDNN with TF32 allowed for this call where `conv_route` found
    the shape exact, else with TF32 off. Never the native low-precision
    conv, which rounds its output to that precision."""
    kw = _conv_kw(geo)
    if compute_dtype is None:
        return F.conv2d(x, w, b, **kw)
    xr, wr = x.to(compute_dtype).float(), w.to(compute_dtype).float()
    if x.device.type == "cuda" and conv_route(
            xr.shape, wr.shape, geo, compute_dtype, x.device) == "tf32":
        with tf32_convs():
            out = F.conv2d(xr, wr, None, **kw)
    else:
        out = F.conv2d(xr, wr, None, **kw)
    return out if b is None else out + _channel(b.float(), out.ndim)


def _layer_seed(step_seed: int, salt: int) -> int:
    return int(np.random.SeedSequence([step_seed, salt]).generate_state(
        1, np.uint64)[0] & 0x7FFF_FFFF_FFFF_FFFF)


def _dropout(l: Layer, x: torch.Tensor, step_seed: int,
             rows: tuple[int, int, int] | None = None) -> torch.Tensor:
    """Keep each element with probability 1 - ratio and scale the kept ones
    by 1/keep. The layer's generator is seeded from the pass's seed and
    crc32 of the layer's name (not hash(), which Python salts per process),
    so two dropout layers draw different masks and a seed reproduces them.
    `rows` (lo, hi, total): x is rows [lo, hi) of a batch of `total`; the
    mask is drawn for the whole batch and sliced, so a batch split over
    shards drops what the whole batch drops on one device of that type."""
    keep = 1.0 - float(l.attr("dropout_ratio", 0.5))
    salt = zlib.crc32(l.name.encode()) & 0x7FFFFFFF
    gen = torch.Generator(device=x.device).manual_seed(_layer_seed(step_seed, salt))
    lo, hi, total = rows or (0, x.shape[0], x.shape[0])
    mask = torch.rand((total,) + tuple(x.shape[1:]), generator=gen,
                      device=x.device)[lo:hi] < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def compute_layer(l: Layer, env: dict[str, torch.Tensor], params: Params, *,
                  step_seed: int | None = None,
                  compute_dtype: torch.dtype | None = None,
                  dropout_rows: tuple[int, int, int] | None = None) -> None:
    """Evaluate one layer into env (tensor name -> NCHW tensor). Dropout
    draws a mask only with a `step_seed` (run_graph's train mode), for
    `dropout_rows` of a larger batch when given (see `_dropout`)."""
    t = l.type
    if t in _DATA_TYPES:
        return
    x = env[l.bottoms[0]] if l.bottoms else None
    top = l.tops[0]
    if t == LT.CONV:
        p = params[l.name]
        b = p.get("b") if l.attr("bias", True) else None
        geo = l.conv_geometry()
        if geo["group"] > 1 and geo["group"] == x.shape[1]:
            with trace.span("forward.depthwise", l.name):
                env[top] = _conv2d(x, p["W"], b, geo, compute_dtype)
        else:
            env[top] = _conv2d(x, p["W"], b, geo, compute_dtype)
    elif t == LT.RELU:
        env[top] = torch.relu(x)
    elif t == LT.POOL:
        env[top] = _pool(x, l)
    elif t == LT.ELTWISE:
        op = l.attr("operation", "sum")
        vals = [env[b] for b in l.bottoms]
        if op == "sum":
            coeffs = l.attr("coeff")
            if coeffs:
                vals = [v * c for v, c in zip(vals, coeffs)]
            env[top] = functools.reduce(torch.add, vals)
        elif op == "max":
            env[top] = functools.reduce(torch.maximum, vals)
        elif op == "prod":
            env[top] = functools.reduce(torch.mul, vals)
        else:
            raise NotImplementedError(op)
    elif t == LT.FC:
        p = params[l.name]
        env[top] = x.reshape(x.shape[0], -1) @ p["W"].T + p["b"]
    elif t == LT.BN:
        env[top] = _batchnorm(x, params[l.name], float(l.attr("eps", 1e-5)))
    elif t == LT.SCALE:
        p = params[l.name]
        out = x * _channel(p["W"], x.ndim)
        env[top] = out + _channel(p["b"], x.ndim) if "b" in p else out
    elif t == LT.DROPOUT:
        env[top] = x if step_seed is None else _dropout(l, x, step_seed,
                                                        dropout_rows)
    elif t == LT.SOFTMAX:
        env[top] = torch.softmax(x, dim=1)
    elif t == LT.FLATTEN:
        env[top] = x.reshape(x.shape[0], -1)
    elif t == LT.CONCAT:
        env[top] = torch.cat([env[b] for b in l.bottoms],
                             dim=int(l.attr("axis", 1)))
    elif t == LT.SELECT:
        idxs = l.attr("indices")
        if idxs is None or l.attr("passthrough", False):
            env[top] = x
        else:
            env[top] = x.index_select(
                1, torch.as_tensor(idxs, dtype=torch.long, device=x.device))
    elif t in (LT.SOFTMAX_LOSS, LT.ACCURACY):
        pass
    else:
        raise NotImplementedError(f"layer type {t}")


def run_graph(graph: Graph, params: Params, inputs: Mapping[str, torch.Tensor],
              *, capture: Sequence[str] = (), train: bool = False,
              generator: torch.Generator | None = None, compute_dtype=None,
              capture_transforms: Mapping[str, Any] | None = None,
              step_seed: int | None = None,
              dropout_rows: tuple[int, int, int] | None = None,
              ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Interpret the graph; returns (outputs, captures), all NCHW.

    `train=True` records gradients and, with a `generator`, applies dropout
    (one seed is drawn from the generator per pass, or `step_seed` given
    by a caller that drew it: the shards of a batch share theirs, and
    `dropout_rows` places each in the batch); otherwise the pass runs
    under no_grad and dropout is the identity."""
    if train and generator is not None and step_seed is None:
        step_seed = draw_step_seed(generator)
    if not train:
        step_seed = None
    with torch.set_grad_enabled(train):
        return _run(graph, params, inputs, capture, capture_transforms,
                    step_seed, as_dtype(compute_dtype), dropout_rows)


def draw_step_seed(generator: torch.Generator) -> int:
    """The seed of one train pass's dropout masks."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))


def _run(graph, params, inputs, capture, capture_transforms, step_seed,
         compute_dtype, dropout_rows=None):
    env: dict[str, torch.Tensor] = {spec.name: inputs[spec.name]
                                    for spec in graph.inputs}
    transforms = capture_transforms or {}
    remaining = set(capture) | set(transforms)
    caps: dict[str, torch.Tensor] = {}
    final = set(graph.outputs())
    last_use = {b: i for i, l in enumerate(graph.layers) for b in l.bottoms}
    for i, l in enumerate(graph.layers):
        compute_layer(l, env, params, step_seed=step_seed,
                      compute_dtype=compute_dtype, dropout_rows=dropout_rows)
        # capture at the point of production, before an in-place (aliased
        # top) successor overwrites the name
        for tname in l.tops:
            if tname in remaining and tname in env:
                tf = transforms.get(tname)
                caps[tname] = tf(env[tname]) if tf is not None else env[tname]
                remaining.discard(tname)
        # eager execution: drop each map after its last consumer, or a
        # whole-net pass would hold every activation at once
        for b in l.bottoms:
            if last_use[b] == i and b not in l.tops and b not in final:
                env.pop(b, None)
    outputs = {t: env[t] for t in final if t in env}
    return outputs, caps


def logits_tensor_of(graph: Graph) -> str:
    """The bottom of the Softmax/loss head, else the last graph output."""
    heads = graph.by_type(LT.SOFTMAX, LT.SOFTMAX_LOSS)
    return heads[0].bottoms[0] if heads else graph.outputs()[-1]


def logits_fn(graph: Graph, logits_tensor: str | None = None):
    """fn(params, x, train=False, generator=None) -> logits, for training
    and eval."""
    logits_tensor = logits_tensor or logits_tensor_of(graph)

    def fn(params, x, train=False, generator=None):
        _, caps = run_graph(graph, params, {graph.inputs[0].name: x},
                            capture=(logits_tensor,), train=train,
                            generator=generator)
        return caps[logits_tensor]

    return fn
