"""Graph executor (port of channel_pruning_tpu/ops/forward.py).

Interprets the shared `Graph` IR eagerly in NCHW with Caffe-layout
parameters (conv W (O, I/g, kh, kw), FC W (O, CHW)). Inference only:
dropout is the identity. `capture` returns interior tensors alongside the
outputs; `capture_transforms` are applied when each tensor is produced, so
only the transformed (sampled) value stays alive.
"""
from __future__ import annotations

import functools
from typing import Any, Mapping, Sequence

import torch
import torch.nn.functional as F

from channel_pruning_tpu.graph.ir import Graph, Layer, LT

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


def compute_layer(l: Layer, env: dict[str, torch.Tensor], params: Params) -> None:
    """Evaluate one layer into env (tensor name -> NCHW tensor)."""
    t = l.type
    if t in _DATA_TYPES:
        return
    x = env[l.bottoms[0]] if l.bottoms else None
    top = l.tops[0]
    if t == LT.CONV:
        p = params[l.name]
        geo = l.conv_geometry()
        b = p.get("b") if l.attr("bias", True) else None
        env[top] = F.conv2d(x, p["W"], b, stride=(geo["sh"], geo["sw"]),
                            padding=(geo["ph"], geo["pw"]),
                            groups=geo["group"])
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
        env[top] = x
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


@torch.no_grad()
def run_graph(graph: Graph, params: Params, inputs: Mapping[str, torch.Tensor],
              *, capture: Sequence[str] = (),
              capture_transforms: Mapping[str, Any] | None = None,
              ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Interpret the graph; returns (outputs, captures), all NCHW."""
    env: dict[str, torch.Tensor] = {spec.name: inputs[spec.name]
                                    for spec in graph.inputs}
    transforms = capture_transforms or {}
    remaining = set(capture) | set(transforms)
    caps: dict[str, torch.Tensor] = {}
    final = set(graph.outputs())
    last_use = {b: i for i, l in enumerate(graph.layers) for b in l.bottoms}
    for i, l in enumerate(graph.layers):
        compute_layer(l, env, params)
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
