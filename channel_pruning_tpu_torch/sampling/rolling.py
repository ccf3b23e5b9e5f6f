"""Rolling activation replay (port of `RollingReplay` and `RollingReplayDAG`,
channel_pruning_tpu/sampling/rolling.py).

The current consumer's bottom activations for the whole calibration set
stay on the device and advance layer by layer with the already-updated
weights: O(L) conv work over the solve instead of a replay from the input
per layer. The frontier is held as per-group tensors; advancing replaces
one group at a time, so the peak is the frontier plus one group's
intermediates (VGG-16 at 500 images: 6.4 GB + 1.3 GB).

`RollingReplay` serves chain graphs; `RollingReplayDAG` serves residual
graphs, whose frontier is the cut of tensors still needed by later layers
(for ResNet: the block input riding the shortcut plus the branch tensor).
Eager PyTorch needs no compiled segments: a segment is a plain loop of
`ops/forward.compute_layer` over the graph's layers. Given the solve's
point plan at construction, the frontier uploads its indices once, so
`advance_to`, `patches_at` and `features_at(device=True)` make no blocking
copy. With a `compute_dtype` (the JAX package's `solve.dtype`, e.g.
"bfloat16") every conv ahead of the frontier runs as `ops/forward._conv2d`
runs it: operands rounded to that dtype, f32 products, sums and outputs;
the frontier itself stays f32, as in the JAX package. On a card the
frontier decides each conv's route once, at construction. `FrontierError`
is the only exception a caller may treat as "fall back to a full replay".
"""
from __future__ import annotations

import numpy as np
import torch

from channel_pruning_tpu_torch.graph.ir import Graph, LT, shapes_of
from channel_pruning_tpu_torch.ops.forward import (compute_layer,
                                                  settle_conv_routes)
from channel_pruning_tpu_torch.ops.patches import (gather_channels_grouped,
                                                   gather_patches_grouped)
from channel_pruning_tpu_torch.sampling.inputs import device_chunk
from channel_pruning_tpu_torch.sampling.sampler import _dtype_of

_STRUCT = (LT.ELTWISE, LT.CONCAT, LT.SELECT)


class FrontierError(RuntimeError):
    """The frontier cannot serve this request (non-monotone advance, or the
    tensor is not at or ahead of the cut); callers fall back to a full
    replay. Any other exception from the rolling path is a bug."""


def is_chain(graph: Graph) -> bool:
    """True when no residual junctions (Eltwise/Concat/Select) sit between
    convs."""
    return not graph.by_type(*_STRUCT)


def estimate_peak_bytes(graph: Graph, n_images: int, dtype_bytes: int = 4) -> int:
    shapes = shapes_of(graph, batch=1)
    return max((int(np.prod(s[1:])) for s in shapes.values() if len(s) == 4),
               default=0) * n_images * dtype_bytes


def _last_use(graph: Graph) -> dict[str, int]:
    """tensor -> index of its last consumer layer (absent if never consumed)."""
    last: dict[str, int] = {}
    for i, l in enumerate(graph.layers):
        for b in l.bottoms:
            last[b] = i
    return last


def estimate_cut_bytes(graph: Graph, n_images: int, dtype_bytes: int = 4) -> int:
    """Peak total size of the live-tensor cut while sweeping the graph in
    order: the DAG frontier's footprint."""
    shapes = shapes_of(graph, batch=1)
    last = _last_use(graph)
    live: dict[str, int] = {}
    for spec in graph.inputs:
        if len(spec.shape) == 4:
            live[spec.name] = int(np.prod(spec.shape[1:])) * dtype_bytes
    peak = sum(live.values())
    for i, l in enumerate(graph.layers):
        for t in l.tops:
            s = shapes.get(t)
            if s is not None and len(s) == 4:
                live[t] = int(np.prod(s[1:])) * dtype_bytes
        for t in list(live):
            if last.get(t, -1) <= i:
                live.pop(t)
        peak = max(peak, sum(live.values()))
    return peak * n_images


def _forward(layers, env: dict[str, torch.Tensor], params,
             until: str | None = None, compute_dtype=None) -> None:
    """Evaluate `layers` in order into env, skipping those whose bottoms are
    not all present; stop once `until` has been produced."""
    if until is not None and until in env:
        return
    for l in layers:
        if not all(b in env for b in l.bottoms):
            continue
        compute_layer(l, env, params, compute_dtype=compute_dtype)
        if until is not None and until in env:
            return


def _upload_plan(plan, device) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """Every tensor's (ys, xs) of a point plan on the device, through one
    host-to-device copy: each is a view of one flat int64 tensor."""
    if not plan:
        return {}
    arrays = [np.asarray(a, np.int64) for pair in plan.values() for a in pair]
    flat = torch.as_tensor(np.concatenate([a.ravel() for a in arrays]),
                           device=device)
    views = [v.view(a.shape) for v, a in
             zip(torch.split(flat, [a.size for a in arrays]), arrays)]
    return {t: (views[2 * k], views[2 * k + 1]) for k, t in enumerate(plan)}


class _Groups:
    """The calibration set as uniform groups of `group_batches` batches on
    the device, and the per-group point slices of a plan. The frontier's
    own plan (`plan`) goes to the device once, at construction, so no
    gather waits on a host-to-device copy; any other plan is uploaded per
    call. `compute_dtype` is the dtype of the convs ahead of the frontier;
    their routes on a card are settled here, at the groups' shape."""

    def __init__(self, graph: Graph, inputs, group_batches: int, device,
                 plan=None, compute_dtype=None):
        n_batches = inputs.shape[0]
        step = min(group_batches, n_batches)
        while n_batches % step:
            step -= 1                    # uniform groups, as the JAX package
        self.group_batches = step
        self.n_groups = n_batches // step
        self.device = device
        self.plan = plan
        self._plan_dev = _upload_plan(plan, device) if plan is not None else {}
        self.compute_dtype = _dtype_of(compute_dtype)
        settle_conv_routes(graph, step * int(inputs.shape[1]),
                           self.compute_dtype, device)

    def upload(self, inputs) -> list[torch.Tensor]:
        step = self.group_batches
        return [device_chunk(inputs, lo, lo + step, self.device)
                for lo in range(0, self.n_groups * step, step)]

    def points(self, plan, tensor: str, gi: int):
        lo, hi = gi * self.group_batches, (gi + 1) * self.group_batches
        if plan is self.plan and tensor in self._plan_dev:
            ys, xs = self._plan_dev[tensor]
            return ys[lo:hi], xs[lo:hi]
        ys, xs = plan[tensor]
        return (torch.as_tensor(ys[lo:hi], dtype=torch.long, device=self.device),
                torch.as_tensor(xs[lo:hi], dtype=torch.long, device=self.device))

    def patches(self, groups, plan, l) -> torch.Tensor:
        """(N, c, kh, kw) input patches of conv layer `l` from its bottom's
        per-group tensors; stays on the device."""
        geo = l.conv_geometry()
        kern = ((geo["kh"], geo["kw"]), (geo["sh"], geo["sw"]),
                (geo["ph"], geo["pw"]))
        return torch.cat([gather_patches_grouped(
            g, *self.points(plan, l.tops[0], gi), *kern)
            for gi, g in enumerate(groups)], dim=0)


def _rows(outs: list[torch.Tensor], device: bool):
    out = torch.cat(outs, dim=0)
    return out if device else out.cpu().numpy()


class RollingReplay:
    """Device-resident activation frontier of a chain graph over the
    calibration set, stored as per-group chunks of `group_batches` batches."""

    def __init__(self, graph: Graph, inputs, *, device, group_batches: int = 10,
                 plan=None, compute_dtype=None):
        self.graph = graph
        self._g = _Groups(graph, inputs, group_batches, device, plan,
                          compute_dtype)
        self.groups: list[torch.Tensor] = self._g.upload(inputs)
        self.tensor = graph.inputs[0].name

    def _ahead(self):
        """The layers after the frontier's producer."""
        cur = self.graph.producer(self.tensor)
        start = self.graph.index(cur.name) if cur is not None else -1
        return self.graph.layers[start + 1:]

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
        layers = self._ahead()
        for i, g in enumerate(self.groups):
            env = {self.tensor: g}
            _forward(layers, env, params, until=tensor,
                     compute_dtype=self._g.compute_dtype)
            self.groups[i] = env[tensor]
            del env, g                      # free the old group before the next
        self.tensor = tensor

    def patches_at(self, plan, conv: str) -> torch.Tensor:
        """(N, c, kh, kw) input patches of `conv` gathered from the frontier
        (which must be at conv's bottom); stays on the device."""
        l = self.graph.layer(conv)
        if l.bottoms[0] != self.tensor:
            raise FrontierError(f"frontier at {self.tensor}, need {l.bottoms[0]}")
        return self._g.patches(self.groups, plan, l)

    @torch.no_grad()
    def features_at(self, params, plan, tensor: str, device: bool = False):
        """Sampled responses (N, C) of `tensor`, computed forward from the
        frontier (which stays where it is). `device=True` keeps them on the
        device as a tensor; otherwise a host array."""
        layers = self._ahead()
        outs = []
        for gi, g in enumerate(self.groups):
            env = {self.tensor: g}
            _forward(layers, env, params, until=tensor,
                     compute_dtype=self._g.compute_dtype)
            if tensor not in env:
                raise FrontierError(f"{tensor} is not ahead of the frontier "
                                    f"at {self.tensor}")
            outs.append(gather_channels_grouped(
                env[tensor], *self._g.points(plan, tensor, gi)))
            del env
        return _rows(outs, device)


class RollingReplayDAG:
    """Rolling frontier for residual graphs. The state is the CUT of
    tensors still needed by later layers, {tensor: [per-group tensors]};
    same O(L) conv work and the same API as `RollingReplay`."""

    def __init__(self, graph: Graph, inputs, *, device, group_batches: int = 10,
                 plan=None, compute_dtype=None):
        self.graph = graph
        self._g = _Groups(graph, inputs, group_batches, device, plan,
                          compute_dtype)
        self.state: dict[str, list[torch.Tensor]] = {
            graph.inputs[0].name: self._g.upload(inputs)}
        self.pos = -1                      # index of the last executed layer
        self.last = _last_use(graph)

    def _segment_to(self, tensor: str):
        """(layers after the cut up to `tensor`'s producer, its index)."""
        prod = self.graph.producer(tensor)
        idx = self.graph.index(prod.name) if prod is not None else -1
        if idx <= self.pos:
            raise FrontierError(f"{tensor} is behind the cut (its producer "
                                f"ran before layer {self.pos + 1}) and not "
                                f"in it {sorted(self.state)}")
        return self.graph.layers[self.pos + 1:idx + 1], idx

    @torch.no_grad()
    def advance_to(self, params, tensor: str) -> None:
        """Execute layers forward until `tensor` is produced; keep the live
        cut. Each old group is freed as its replacement is computed."""
        if tensor in self.state:
            return
        layers, idx = self._segment_to(tensor)
        keep_tops = set(self.graph.layers[idx].tops)
        new_state: dict[str, list[torch.Tensor]] = {}
        for gi in range(self._g.n_groups):
            env = {t: v[gi] for t, v in self.state.items()}
            for v in self.state.values():
                v[gi] = None
            _forward(layers, env, params,
                     compute_dtype=self._g.compute_dtype)
            for t, a in env.items():
                if self.last.get(t, -1) > idx or t in keep_tops:
                    new_state.setdefault(t, []).append(a)
            del env
        self.state = new_state
        self.pos = idx

    def patches_at(self, plan, conv: str) -> torch.Tensor:
        """(N, c, kh, kw) input patches of `conv` from the cut (its bottom
        must be live); stays on the device."""
        l = self.graph.layer(conv)
        if l.bottoms[0] not in self.state:
            raise FrontierError(
                f"{l.bottoms[0]} not in the live cut {sorted(self.state)}")
        return self._g.patches(self.state[l.bottoms[0]], plan, l)

    @torch.no_grad()
    def features_at(self, params, plan, tensor: str, device: bool = False):
        """Sampled responses (N, C) of `tensor`: straight from the cut when it
        is live, otherwise computed forward from the cut (state unchanged).
        `device=True` keeps them on the device as a tensor."""
        layers = None if tensor in self.state else self._segment_to(tensor)[0]
        outs = []
        for gi in range(self._g.n_groups):
            if layers is None:
                v = self.state[tensor][gi]
            else:
                env = {t: g[gi] for t, g in self.state.items()}
                _forward(layers, env, params,
                         compute_dtype=self._g.compute_dtype)
                v = env.pop(tensor)
                del env
            outs.append(gather_channels_grouped(
                v, *self._g.points(plan, tensor, gi)))
        return _rows(outs, device)
