"""Rolling activation replay for chain graphs (port of `RollingReplay`,
channel_pruning_tpu/sampling/rolling.py).

The current consumer's bottom activations for the whole calibration set
stay on the device and advance layer by layer with the already-updated
weights: O(L) conv work over the solve instead of a replay from the input
per layer. The frontier is a list of per-group tensors; advancing replaces
one group at a time, so the peak is the frontier plus one group's output
(VGG-16 at 500 images: 6.4 GB + 1.3 GB). Residual topologies need the DAG
cut (`RollingReplayDAG`), which is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from channel_pruning_tpu.graph.ir import Graph, LT, shapes_of
from channel_pruning_tpu_torch.ops.forward import compute_layer
from channel_pruning_tpu_torch.ops.patches import gather_patches_grouped
from channel_pruning_tpu_torch.sampling.inputs import device_chunk

_STRUCT = (LT.ELTWISE, LT.CONCAT, LT.SELECT)


class FrontierError(RuntimeError):
    """The frontier cannot serve this request (non-monotone advance, or the
    tensor is not at the cut); callers fall back to a full replay."""


def is_chain(graph: Graph) -> bool:
    """True when no residual junctions (Eltwise/Concat/Select) sit between
    convs."""
    return not graph.by_type(*_STRUCT)


def estimate_peak_bytes(graph: Graph, n_images: int, dtype_bytes: int = 4) -> int:
    shapes = shapes_of(graph, batch=1)
    return max((int(np.prod(s[1:])) for s in shapes.values() if len(s) == 4),
               default=0) * n_images * dtype_bytes


class RollingReplay:
    """Device-resident activation frontier over the calibration set, stored
    as per-group chunks of `group_batches` batches."""

    def __init__(self, graph: Graph, inputs, *, device, group_batches: int = 10):
        self.graph = graph
        self.batch_size = inputs.shape[1]
        n_batches = inputs.shape[0]
        step = min(group_batches, n_batches)
        while n_batches % step:
            step -= 1
        self.group_batches = step
        self.groups: list[torch.Tensor] = [
            device_chunk(inputs, lo, lo + step, device)
            for lo in range(0, n_batches, step)]
        self.tensor = graph.inputs[0].name
        self.device = device

    @torch.no_grad()
    def advance_to(self, params, tensor: str) -> None:
        """Move the frontier forward to `tensor` with the CURRENT params."""
        if tensor == self.tensor:
            return
        cur = self.graph.producer(self.tensor)
        prod = self.graph.producer(tensor)
        if prod is None or (cur is not None and
                            self.graph.index(prod.name) <=
                            self.graph.index(cur.name)):
            raise FrontierError(f"cannot rewind frontier to {tensor}")
        start = self.graph.index(cur.name) if cur is not None else -1
        layers = self.graph.layers[start + 1:]
        for i, g in enumerate(self.groups):
            env = {self.tensor: g}
            for l in layers:
                if not all(b in env for b in l.bottoms):
                    continue
                compute_layer(l, env, params)
                if tensor in env:
                    break
            self.groups[i] = env[tensor]
            del env, g                      # free the old group before the next
        self.tensor = tensor

    def patches_at(self, plan, conv: str) -> torch.Tensor:
        """(N, c, kh, kw) input patches of `conv` gathered from the frontier
        (which must be at conv's bottom); stays on the device."""
        l = self.graph.layer(conv)
        if l.bottoms[0] != self.tensor:
            raise FrontierError(f"frontier at {self.tensor}, need {l.bottoms[0]}")
        geo = l.conv_geometry()
        kern = ((geo["kh"], geo["kw"]), (geo["sh"], geo["sw"]),
                (geo["ph"], geo["pw"]))
        ys_all, xs_all = plan[l.tops[0]]
        outs = []
        for gi, g in enumerate(self.groups):
            lo, hi = gi * self.group_batches, (gi + 1) * self.group_batches
            ys = torch.as_tensor(ys_all[lo:hi], dtype=torch.long, device=self.device)
            xs = torch.as_tensor(xs_all[lo:hi], dtype=torch.long, device=self.device)
            outs.append(gather_patches_grouped(g, ys, xs, *kern))
        return torch.cat(outs, dim=0)
