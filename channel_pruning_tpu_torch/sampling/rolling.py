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
from channel_pruning_tpu_torch.ops.patches import (
    gather_channels_grouped, gather_channels_per_image, gather_patches_grouped,
    gather_patches_per_image, image_rows)
from channel_pruning_tpu_torch.parallel import mesh as mesh_mod
from channel_pruning_tpu_torch.sampling.inputs import device_images
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
    their routes on a card are settled here, at the groups' shape.

    A group is a list of per-shard tensors. Without a mesh it holds one
    tensor, the group's images. Under a `mesh` of more than one shard the
    group's image axis is zero-padded to a multiple of the shard count and
    split evenly: shard s holds images [s*per, (s+1)*per) on its device
    and advances them there; its gathers take each image's own points, and
    the rows come back on the lead device in the one-device order (the
    padding's dropped)."""

    def __init__(self, graph: Graph, inputs, group_batches: int, device,
                 plan=None, compute_dtype=None, mesh=None):
        n_batches = inputs.shape[0]
        step = min(group_batches, n_batches)
        while n_batches % step:
            step -= 1                    # uniform groups, as the JAX package
        self.group_batches = step
        self.n_groups = n_batches // step
        self.bs = int(inputs.shape[1])
        self.mesh = mesh if mesh_mod.is_sharded(mesh) else \
            mesh_mod.Mesh((torch.device(device),))
        self.device = self.mesh.lead
        n_img = step * self.bs
        self.bounds = mesh_mod.shard_bounds(n_img, self.mesh)
        self.per = -(-n_img // self.mesh.size)       # images a shard
        self.plan = plan
        self._plan_dev = {d: _upload_plan(plan, d) if plan is not None else {}
                          for d in self.mesh.distinct}
        # each shard image's batch within its group (padding: the last)
        self._bidx = [torch.as_tensor(
            np.minimum(np.arange(lo, lo + self.per) // self.bs, step - 1),
            device=d) for (lo, _), d in zip(self.bounds, self.mesh.devices)]
        self.compute_dtype = _dtype_of(compute_dtype)
        for d in self.mesh.distinct:
            settle_conv_routes(graph, self.per, self.compute_dtype, d)

    @property
    def sharded(self) -> bool:
        return self.mesh.size > 1

    def upload(self, inputs) -> list[list[torch.Tensor]]:
        groups = []
        for gi in range(self.n_groups):
            base = gi * self.group_batches * self.bs
            parts = []
            for (lo, hi), d in zip(self.bounds, self.mesh.devices):
                x = device_images(inputs, base + lo, base + hi, d) if hi > lo \
                    else None
                if hi - lo < self.per:
                    pad = torch.zeros((self.per - (hi - lo),)
                                      + tuple(inputs.shape[2:]), device=d)
                    x = pad if x is None else torch.cat([x, pad])
                parts.append(x)
            groups.append(parts)
        return groups

    def params_by_device(self, params, layers) -> dict:
        """{device: params}: under a mesh the segment's layers copied once
        to each other distinct device (the running weights change every
        layer)."""
        if not self.sharded:
            return {self.device: params}
        seg = {l.name: params[l.name] for l in layers if l.name in params}
        return mesh_mod.replicate(seg, self.mesh)

    def _plan_on(self, plan, tensor: str, device):
        if plan is self.plan and tensor in self._plan_dev[device]:
            return self._plan_dev[device][tensor]
        ys, xs = plan[tensor]
        return (torch.as_tensor(ys, dtype=torch.long, device=device),
                torch.as_tensor(xs, dtype=torch.long, device=device))

    def points(self, plan, tensor: str, gi: int):
        """(G, P) points of group gi on the device (one shard)."""
        ys, xs = self._plan_on(plan, tensor, self.device)
        lo, hi = gi * self.group_batches, (gi + 1) * self.group_batches
        return ys[lo:hi], xs[lo:hi]

    def image_points(self, plan, tensor: str, gi: int, s: int):
        """(per, P) points of each image of shard s of group gi."""
        d = self.mesh.devices[s]
        ys, xs = self._plan_on(plan, tensor, d)
        idx = self._bidx[s] + gi * self.group_batches
        return ys[idx], xs[idx]

    def _image_rows(self, parts: list[torch.Tensor]) -> torch.Tensor:
        t = mesh_mod.gather_rows(parts, self.mesh,
                                 self.group_batches * self.bs)
        return image_rows(t, self.bs)

    def patches(self, groups, plan, l) -> torch.Tensor:
        """(N, c, kh, kw) input patches of conv layer `l` from its bottom's
        per-group tensors; stays on the (lead) device."""
        geo = l.conv_geometry()
        kern = ((geo["kh"], geo["kw"]), (geo["sh"], geo["sw"]),
                (geo["ph"], geo["pw"]))
        top = l.tops[0]
        if not self.sharded:
            return torch.cat([gather_patches_grouped(
                g[0], *self.points(plan, top, gi), *kern)
                for gi, g in enumerate(groups)], dim=0)
        return torch.cat([self._image_rows([gather_patches_per_image(
            v, *self.image_points(plan, top, gi, s), *kern)
            for s, v in enumerate(g)]) for gi, g in enumerate(groups)], dim=0)

    def channels(self, parts: list[torch.Tensor], plan, tensor: str,
                 gi: int) -> torch.Tensor:
        """Sampled (rows, C) of `tensor` from group gi's per-shard values."""
        if not self.sharded:
            return gather_channels_grouped(parts[0],
                                           *self.points(plan, tensor, gi))
        return self._image_rows([gather_channels_per_image(
            v, *self.image_points(plan, tensor, gi, s))
            for s, v in enumerate(parts)])


def _rows(outs: list[torch.Tensor], device: bool):
    out = torch.cat(outs, dim=0)
    return out if device else out.cpu().numpy()


class RollingReplay:
    """Device-resident activation frontier of a chain graph over the
    calibration set, stored as per-group chunks of `group_batches` batches
    (each split by images over a `mesh`'s shards, see `_Groups`)."""

    def __init__(self, graph: Graph, inputs, *, device, group_batches: int = 10,
                 plan=None, compute_dtype=None, mesh=None):
        self.graph = graph
        self._g = _Groups(graph, inputs, group_batches, device, plan,
                          compute_dtype, mesh)
        self._parts: list[list[torch.Tensor]] = self._g.upload(inputs)
        self.tensor = graph.inputs[0].name

    @property
    def groups(self) -> list:
        """The frontier's groups: a tensor each, or under a mesh each
        group's per-shard tensors."""
        return self._parts if self._g.sharded else [g[0] for g in self._parts]

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
        by_dev = self._g.params_by_device(params, layers)
        for g in self._parts:
            for s, d in enumerate(self._g.mesh.devices):
                env = {self.tensor: g[s]}
                g[s] = None                 # free the old part before the next
                _forward(layers, env, by_dev[d], until=tensor,
                         compute_dtype=self._g.compute_dtype)
                g[s] = env[tensor]
                del env
        self.tensor = tensor

    def patches_at(self, plan, conv: str) -> torch.Tensor:
        """(N, c, kh, kw) input patches of `conv` gathered from the frontier
        (which must be at conv's bottom); stays on the device."""
        l = self.graph.layer(conv)
        if l.bottoms[0] != self.tensor:
            raise FrontierError(f"frontier at {self.tensor}, need {l.bottoms[0]}")
        return self._g.patches(self._parts, plan, l)

    @torch.no_grad()
    def features_at(self, params, plan, tensor: str, device: bool = False):
        """Sampled responses (N, C) of `tensor`, computed forward from the
        frontier (which stays where it is). `device=True` keeps them on the
        device as a tensor; otherwise a host array."""
        layers = self._ahead()
        by_dev = self._g.params_by_device(params, layers)
        outs = []
        for gi, g in enumerate(self._parts):
            parts = []
            for s, d in enumerate(self._g.mesh.devices):
                env = {self.tensor: g[s]}
                _forward(layers, env, by_dev[d], until=tensor,
                         compute_dtype=self._g.compute_dtype)
                if tensor not in env:
                    raise FrontierError(f"{tensor} is not ahead of the "
                                        f"frontier at {self.tensor}")
                parts.append(env[tensor])
                del env
            outs.append(self._g.channels(parts, plan, tensor, gi))
        return _rows(outs, device)


class RollingReplayDAG:
    """Rolling frontier for residual graphs. The state is the CUT of
    tensors still needed by later layers, {tensor: [per-group tensors]};
    same O(L) conv work and the same API as `RollingReplay`, and the same
    split of each group over a `mesh`."""

    def __init__(self, graph: Graph, inputs, *, device, group_batches: int = 10,
                 plan=None, compute_dtype=None, mesh=None):
        self.graph = graph
        self._g = _Groups(graph, inputs, group_batches, device, plan,
                          compute_dtype, mesh)
        self._cut: dict[str, list[list[torch.Tensor]]] = {
            graph.inputs[0].name: self._g.upload(inputs)}
        self.pos = -1                      # index of the last executed layer
        self.last = _last_use(graph)

    @property
    def state(self) -> dict:
        """The live cut {tensor: groups}: a tensor a group, or under a mesh
        each group's per-shard tensors."""
        if self._g.sharded:
            return self._cut
        return {t: [g[0] for g in v] for t, v in self._cut.items()}

    def _segment_to(self, tensor: str):
        """(layers after the cut up to `tensor`'s producer, its index)."""
        prod = self.graph.producer(tensor)
        idx = self.graph.index(prod.name) if prod is not None else -1
        if idx <= self.pos:
            raise FrontierError(f"{tensor} is behind the cut (its producer "
                                f"ran before layer {self.pos + 1}) and not "
                                f"in it {sorted(self._cut)}")
        return self.graph.layers[self.pos + 1:idx + 1], idx

    @torch.no_grad()
    def advance_to(self, params, tensor: str) -> None:
        """Execute layers forward until `tensor` is produced; keep the live
        cut. Each old group is freed as its replacement is computed."""
        if tensor in self._cut:
            return
        layers, idx = self._segment_to(tensor)
        keep_tops = set(self.graph.layers[idx].tops)
        by_dev = self._g.params_by_device(params, layers)
        new_state: dict[str, list[list[torch.Tensor]]] = {}
        for gi in range(self._g.n_groups):
            for s, d in enumerate(self._g.mesh.devices):
                env = {t: v[gi][s] for t, v in self._cut.items()}
                for v in self._cut.values():
                    v[gi][s] = None
                _forward(layers, env, by_dev[d],
                         compute_dtype=self._g.compute_dtype)
                for t, a in env.items():
                    if self.last.get(t, -1) > idx or t in keep_tops:
                        new_state.setdefault(t, [[] for _ in range(
                            self._g.n_groups)])[gi].append(a)
                del env
        self._cut = new_state
        self.pos = idx

    def patches_at(self, plan, conv: str) -> torch.Tensor:
        """(N, c, kh, kw) input patches of `conv` from the cut (its bottom
        must be live); stays on the device."""
        l = self.graph.layer(conv)
        if l.bottoms[0] not in self._cut:
            raise FrontierError(
                f"{l.bottoms[0]} not in the live cut {sorted(self._cut)}")
        return self._g.patches(self._cut[l.bottoms[0]], plan, l)

    @torch.no_grad()
    def features_at(self, params, plan, tensor: str, device: bool = False):
        """Sampled responses (N, C) of `tensor`: straight from the cut when it
        is live, otherwise computed forward from the cut (state unchanged).
        `device=True` keeps them on the device as a tensor."""
        layers = None if tensor in self._cut else self._segment_to(tensor)[0]
        by_dev = None if layers is None else \
            self._g.params_by_device(params, layers)
        outs = []
        for gi in range(self._g.n_groups):
            if layers is None:
                parts = self._cut[tensor][gi]
            else:
                parts = []
                for s, d in enumerate(self._g.mesh.devices):
                    env = {t: g[gi][s] for t, g in self._cut.items()}
                    _forward(layers, env, by_dev[d],
                             compute_dtype=self._g.compute_dtype)
                    parts.append(env.pop(tensor))
                    del env
            outs.append(self._g.channels(parts, plan, tensor, gi))
        return _rows(outs, device)
