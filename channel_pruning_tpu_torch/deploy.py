"""Serving export (port of channel_pruning_tpu/deploy.py, with `torch.export`
in place of StableHLO): `export_serialized` bakes the parameters into an
nn.Module whose forward is the executor, exports it for a fixed input
shape and saves a `.pt2` archive that `load_serialized` (or plain
`torch.export.load`) replays without the graph IR.
"""
from __future__ import annotations

from pathlib import Path
from typing import Mapping

import torch
from torch import nn

from channel_pruning_tpu_torch.convert import GraphParams, params_on
from channel_pruning_tpu_torch.graph.ir import Graph
from channel_pruning_tpu_torch.ops.forward import run_graph


def _output(graph: Graph, output: str | None, x, params) -> torch.Tensor:
    name = output or graph.outputs()[-1]
    outs, caps = run_graph(graph, params, {graph.inputs[0].name: x},
                           capture=(name,))
    return caps.get(name, outs.get(name))


class ServingModule(nn.Module):
    """x -> one graph tensor (default: the last output), parameters baked
    in as (frozen) module parameters."""

    def __init__(self, graph: Graph, params: Mapping, output: str | None = None,
                 *, device):
        super().__init__()
        self.graph, self.output = graph, output
        self.weights = GraphParams(params, device, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _output(self.graph, self.output, x, self.weights.as_dict())


def serving_fn(graph: Graph, params: Mapping | None = None,
               output: str | None = None, *, device):
    """fn(x) with the parameters baked, or fn(params, x) without them."""
    if params is not None:
        dev = params_on(params, device)
        return lambda x: _output(graph, output, x, dev)
    return lambda p, x: _output(graph, output, x, p)


def export_serialized(graph: Graph, params: Mapping, path: str | Path,
                      batch: int | None = None, output: str | None = None, *,
                      device) -> int:
    """Export the parameter-baked forward at input shape (batch, C, H, W)
    to a `.pt2` archive at `path`; returns its size in bytes."""
    shape = graph.inputs[0].shape
    module = ServingModule(graph, params, output, device=device).eval()
    x = torch.zeros((batch or shape[0],) + tuple(shape[1:]), device=device)
    with torch.no_grad():
        exported = torch.export.export(module, (x,))
    torch.export.save(exported, str(path))
    return Path(path).stat().st_size


def load_serialized(path: str | Path):
    """Rehydrate an exported forward: fn(x) on the device it was exported
    on."""
    module = torch.export.load(str(path)).module()

    def fn(x):
        with torch.no_grad():
            return module(x)

    return fn
