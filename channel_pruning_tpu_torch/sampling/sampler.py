"""Activation sampling and the frozen calibration cache (port of
channel_pruning_tpu/sampling/sampler.py).

* `freeze` / `sample_features`: one chunked forward over the calibration
  set captures every requested tensor and gathers its sampled channel
  vectors on the device as each tensor is produced;
* `sample_patches`: replay the current graph up to a conv's bottom and
  gather its (N, c, kh, kw) input patches at the planned output points;
* `sample_dense`: replay and capture whole tensors, one row per image (the
  inputs of an FC consumer, for fitfc), always in f32;
* `FrozenCache`: the npz layout of the JAX package, so a cache frozen there
  loads here.

Row-order contract (ops/patches.py): within a batch of `bs` images with `P`
points, row = p * bs + b; batches are concatenated in order.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from channel_pruning_tpu_torch.graph.ir import Graph, LT, shapes_of
from channel_pruning_tpu_torch.ops.forward import run_graph
from channel_pruning_tpu_torch.ops.patches import (
    gather_channels_grouped, gather_channels_per_image, gather_patches_grouped,
    gather_patches_per_image, image_rows)
from channel_pruning_tpu_torch.parallel import mesh as mesh_mod
from channel_pruning_tpu_torch.sampling.inputs import (JAX_SPEC_KEY, SPEC_KEY,
                                                       SyntheticInputs,
                                                       device_chunk,
                                                       device_images)
from channel_pruning_tpu_torch.utils import trace


def make_point_plan(shapes: Mapping[str, tuple[int, ...]], tensors: Sequence[str],
                    n_batches: int, n_points: int, seed: int = 0,
                    share_key: Callable[[str], str] | None = None,
                    ) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Per-(batch, tensor) sample coordinates {tensor: (ys, xs)}, int32
    (n_batches, n_points); tensors with the same `share_key` share points.
    The same numpy draws as the JAX package, so both plans are equal."""
    rng = np.random.default_rng(seed)
    drawn: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    plan: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    for t in tensors:
        shp = shapes[t]
        if len(shp) != 4:
            plan[t] = (np.zeros((n_batches, 0), np.int32),) * 2  # dense tensor
            continue
        key = share_key(t) if share_key else t
        if key not in drawn:
            h, w = shp[2], shp[3]
            drawn[key] = (rng.integers(0, h, (n_batches, n_points)).astype(np.int32),
                          rng.integers(0, w, (n_batches, n_points)).astype(np.int32))
        plan[t] = drawn[key]
    return plan


# `solve.dtype` names (the JAX package's) -> the conv dtype of a replay
REPLAY_DTYPES = {"float32": None, "bfloat16": torch.bfloat16,
                 "bf16": torch.bfloat16}


def _dtype_of(name):
    return None if name is None else REPLAY_DTYPES[name]


def _chunk_iter(n_batches: int, chunk_batches: int):
    step = min(chunk_batches, n_batches)
    while n_batches % step:
        step -= 1        # uniform chunks, as the JAX package cuts them
    for i in range(0, n_batches, step):
        yield i, i + step


def _plan_slice(plan, t: str, lo: int, hi: int, device):
    ys, xs = plan[t]
    return (torch.as_tensor(ys[lo:hi], dtype=torch.long, device=device),
            torch.as_tensor(xs[lo:hi], dtype=torch.long, device=device))


def _shards(inputs, lo: int, hi: int, mesh):
    """(device, first image, end image, that shard's images on its device)
    of each non-empty shard of batches [lo, hi), images split evenly over
    the mesh in order."""
    bs = int(inputs.shape[1])
    for (a, b), dev in zip(mesh_mod.shard_bounds((hi - lo) * bs, mesh),
                           mesh.devices):
        if b > a:
            yield dev, a, b, device_images(inputs, lo * bs + a, lo * bs + b,
                                           dev)


def _image_points(plan, t: str, lo: int, a: int, b: int, bs: int, device):
    """Each image's points, (b - a, P), for images [a, b) of the chunk that
    starts at batch `lo`."""
    ys, xs = plan[t]
    bidx = lo + np.arange(a, b) // bs
    return (torch.as_tensor(ys[bidx], dtype=torch.long, device=device),
            torch.as_tensor(xs[bidx], dtype=torch.long, device=device))


def _sharded_captures(sub, params, inputs, lo: int, hi: int, mesh,
                      make_tf, compute_dtype=None) -> dict[str, torch.Tensor]:
    """One chunk's captures under a mesh: each shard runs its own images on
    its device, `make_tf(lo, a, b, device)` gives the capture transforms
    for images [a, b) of the chunk, and each capture's pieces are gathered
    on the lead device in image order."""
    input_name = sub.inputs[0].name
    parts: dict[str, list[torch.Tensor]] = {}
    for dev, a, b, x in _shards(inputs, lo, hi, mesh):
        _, caps = run_graph(sub, params[dev], {input_name: x},
                            capture_transforms=make_tf(lo, a, b, dev),
                            compute_dtype=_dtype_of(compute_dtype))
        for t, v in caps.items():
            parts.setdefault(t, []).append(v)
    return {t: mesh_mod.gather_rows(v, mesh) for t, v in parts.items()}


def sample_features(graph: Graph, params, inputs,
                    plan: Mapping[str, tuple[np.ndarray, np.ndarray]],
                    tensors: Sequence[str], *, device,
                    chunk_batches: int = 25,
                    compute_dtype: str | None = None,
                    mesh=None, phase: str = "sample") -> dict[str, np.ndarray]:
    """Ground-truth response sampling: {tensor: (n_batches*P*bs, C)} (dense
    (n_images, D) for non-spatial tensors). inputs: (n_batches, bs, C, H, W)
    host array or SyntheticInputs; params on `device`. `compute_dtype`
    ("bfloat16") runs the convs on rounded operands with f32 sums, for
    replays only: the freeze's ground truth stays f32. Under a `mesh` of
    more than one shard (`device` its lead) each chunk's images are split
    over the shards, each uploads and runs only its own, and the rows come
    back in the one-device order. Each chunk's upload and forward, and the
    copy of the samples to the host, are the spans `<phase>.upload`,
    `<phase>.forward` and `<phase>.to_host` (utils/trace)."""
    up, fwd, to_host = (f"{phase}.upload", f"{phase}.forward",
                        f"{phase}.to_host")
    tensors = tuple(tensors)
    input_name = graph.inputs[0].name
    sub = graph.ancestors_subgraph(tensors)     # skip layers past the captures
    outs: dict[str, list[torch.Tensor]] = {t: [] for t in tensors}
    if mesh_mod.is_sharded(mesh):
        bs = int(inputs.shape[1])
        by_dev = mesh_mod.replicate(params, mesh)

        def make_tf(lo, a, b, dev):
            def tf_for(t):
                def tf(v):
                    if v.dim() != 4 or plan[t][0].shape[1] == 0:
                        return v.reshape(v.shape[0], -1)
                    return gather_channels_per_image(
                        v, *_image_points(plan, t, lo, a, b, bs, dev))
                return tf
            return {t: tf_for(t) for t in tensors}

        for lo, hi in _chunk_iter(inputs.shape[0], chunk_batches):
            with trace.span(fwd):             # each shard uploads its own
                caps = _sharded_captures(sub, by_dev, inputs, lo, hi, mesh,
                                         make_tf, compute_dtype)
            for t in tensors:
                v = caps[t]
                outs[t].append(image_rows(v, bs) if v.dim() > 2 else v)
        with trace.span(to_host):
            return {t: torch.cat(v, dim=0).cpu().numpy()
                    for t, v in outs.items()}
    for lo, hi in _chunk_iter(inputs.shape[0], chunk_batches):
        with trace.span(up):
            x = device_chunk(inputs, lo, hi, device)
            pts = {t: _plan_slice(plan, t, lo, hi, device) for t in tensors}

        def make_tf(t):
            def tf(v):
                ys, xs = pts[t]
                if v.dim() != 4 or ys.shape[1] == 0:
                    return v.reshape(v.shape[0], -1)
                return gather_channels_grouped(v, ys, xs)
            return tf

        with trace.span(fwd):
            _, caps = run_graph(sub, params, {input_name: x},
                                capture_transforms={t: make_tf(t)
                                                    for t in tensors},
                                compute_dtype=_dtype_of(compute_dtype))
        for t in tensors:
            outs[t].append(caps[t])
    with trace.span(to_host):
        return {t: torch.cat(v, dim=0).cpu().numpy() for t, v in outs.items()}


def sample_patches(graph: Graph, params, inputs, conv: str,
                   plan: Mapping[str, tuple[np.ndarray, np.ndarray]], *,
                   device, chunk_batches: int = 25,
                   compute_dtype: str | None = None, mesh=None) -> torch.Tensor:
    """Replay the current graph and gather the (N, c, kh, kw) input patches
    of `conv` at its planned output points; stays on `device`. The convs
    run in `compute_dtype` as in `sample_features`; under a `mesh` each
    chunk is split by images as there, and the rows land on its lead."""
    l = graph.layer(conv)
    geo = l.conv_geometry()
    bottom, top = l.bottoms[0], l.tops[0]
    kern = ((geo["kh"], geo["kw"]), (geo["sh"], geo["sw"]), (geo["ph"], geo["pw"]))
    input_name = graph.inputs[0].name
    sub = graph.ancestors_subgraph((bottom,))   # replay only up to `bottom`
    outs = []
    if mesh_mod.is_sharded(mesh):
        bs = int(inputs.shape[1])
        by_dev = mesh_mod.replicate(params, mesh)

        def make_tf(lo, a, b, dev):
            pts = _image_points(plan, top, lo, a, b, bs, dev)
            return {bottom: lambda v: gather_patches_per_image(v, *pts, *kern)}

        for lo, hi in _chunk_iter(inputs.shape[0], chunk_batches):
            outs.append(image_rows(_sharded_captures(
                sub, by_dev, inputs, lo, hi, mesh, make_tf,
                compute_dtype)[bottom], bs))
        return torch.cat(outs, dim=0)
    for lo, hi in _chunk_iter(inputs.shape[0], chunk_batches):
        x = device_chunk(inputs, lo, hi, device)
        ys, xs = _plan_slice(plan, top, lo, hi, device)
        _, caps = run_graph(
            sub, params, {input_name: x},
            capture_transforms={bottom: lambda v: gather_patches_grouped(
                v, ys, xs, *kern)}, compute_dtype=_dtype_of(compute_dtype))
        outs.append(caps[bottom])
    return torch.cat(outs, dim=0)


def sample_dense(graph: Graph, params, inputs, tensors: Sequence[str], *,
                 device, chunk_batches: int = 25,
                 mesh=None) -> dict[str, torch.Tensor]:
    """Capture whole tensors, one row per image: {t: (n_images, ...)},
    left on `device` (the inputs of an FC consumer under fitfc). Chunked
    as `sample_features` is, and split by images under a `mesh`."""
    tensors = tuple(tensors)
    input_name = graph.inputs[0].name
    sub = graph.ancestors_subgraph(tensors)
    outs: dict[str, list[torch.Tensor]] = {t: [] for t in tensors}
    if mesh_mod.is_sharded(mesh):
        by_dev = mesh_mod.replicate(params, mesh)
        for lo, hi in _chunk_iter(inputs.shape[0], chunk_batches):
            caps = _sharded_captures(
                sub, by_dev, inputs, lo, hi, mesh,
                lambda *_: {t: (lambda v: v) for t in tensors})
            for t in tensors:
                outs[t].append(caps[t])
        return {t: torch.cat(v, dim=0) for t, v in outs.items()}
    for lo, hi in _chunk_iter(inputs.shape[0], chunk_batches):
        x = device_chunk(inputs, lo, hi, device)
        _, caps = run_graph(sub, params, {input_name: x}, capture=tensors)
        for t in tensors:
            outs[t].append(caps[t])
    return {t: torch.cat(v, dim=0) for t, v in outs.items()}


@dataclass
class FrozenCache:
    """The calibration snapshot: inputs + point plan + ground-truth sampled
    responses of the ORIGINAL net."""

    inputs: np.ndarray | SyntheticInputs                 # (n_batches, bs, C, H, W)
    plan: dict[str, tuple[np.ndarray, np.ndarray]]       # tensor -> (ys, xs)
    feats: dict[str, np.ndarray]                         # tensor -> sampled rows
    labels: np.ndarray | None = None                     # (n_batches, bs) int

    @property
    def batch_size(self) -> int:
        return int(self.inputs.shape[1])

    @property
    def n_batches(self) -> int:
        return int(self.inputs.shape[0])

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        if isinstance(self.inputs, SyntheticInputs):
            payload = {SPEC_KEY: self.inputs.spec()}
        else:
            payload = {"inputs": self.inputs}
        if self.labels is not None:
            payload["labels"] = self.labels
        for t, (ys, xs) in self.plan.items():
            payload[f"plan_ys::{t}"] = ys
            payload[f"plan_xs::{t}"] = xs
        for t, f in self.feats.items():
            payload[f"feats::{t}"] = f
        np.savez(path, **payload)

    @staticmethod
    def load(path: str | Path) -> "FrozenCache":
        with np.load(path) as z:
            if JAX_SPEC_KEY in z.files:
                raise ValueError(
                    f"{path}: frozen by the JAX package from threefry "
                    "synthetic inputs, which this package cannot regenerate; "
                    "refreeze (or freeze from a host array)")
            plan: dict[str, tuple[np.ndarray, np.ndarray]] = {}
            feats: dict[str, np.ndarray] = {}
            for k in z.files:
                if k.startswith("plan_ys::"):
                    t = k.split("::", 1)[1]
                    plan[t] = (z[k], z[f"plan_xs::{t}"])
                elif k.startswith("feats::"):
                    feats[k.split("::", 1)[1]] = z[k]
            inputs = (SyntheticInputs.from_spec(z[SPEC_KEY])
                      if SPEC_KEY in z.files else z["inputs"])
            labels = z["labels"] if "labels" in z.files else None
        return FrozenCache(inputs=inputs, plan=plan, feats=feats, labels=labels)


def clamp_chunk_for_hbm(graph: Graph, bs: int, chunk_batches: int,
                        budget_bytes: int = 4 << 30) -> int:
    """Bound images per replay step so the largest single feature map of a
    chunk stays ~<= `budget_bytes`."""
    shapes = shapes_of(graph, batch=1)
    per_image = max((int(np.prod(s)) * 4 for s in shapes.values()
                     if len(s) == 4), default=0)
    if not per_image:
        return chunk_batches
    cap = max(1, budget_bytes // (per_image * bs))
    if cap < chunk_batches:
        print(f"[sampler] clamping replay chunk {chunk_batches} -> {cap} "
              f"batches (largest map {per_image / 1e6:.0f} MB/image)")
        return cap
    return chunk_batches


def resnet_share_key(graph: Graph) -> Callable[[str], str]:
    """Map each residual-sum-reachable tensor to its Eltwise junction so all
    branch tops share sample points."""
    groups: dict[str, str] = {}
    for s in graph.by_type(LT.ELTWISE):
        for b in s.bottoms:
            groups[b] = s.tops[0]
        groups[s.tops[0]] = s.tops[0]
    return lambda t: groups.get(t, t)


def freeze_tensor_set(graph: Graph, include_fc: bool = True) -> tuple[str, ...]:
    """Every conv top; Eltwise tops and bottoms for residual nets; FC tops
    only when asked (skipping them drops the FC stack from the freeze)."""
    names = [graph.layer(c).tops[0] for c in graph.convs]
    for e in graph.by_type(LT.ELTWISE):
        names.append(e.tops[0])
        names.extend(e.bottoms)
    if include_fc:
        names.extend(graph.layer(f).tops[0] for f in graph.fcs)
    seen: set = set()
    return tuple(t for t in names if not (t in seen or seen.add(t)))


def params_for_tensors(graph: Graph, params, tensors: Sequence[str]):
    """Filter params to the layers of `ancestors_subgraph(tensors)`."""
    needed = {l.name for l in graph.ancestors_subgraph(tuple(tensors)).layers}
    return {k: v for k, v in params.items() if k in needed}


def freeze(graph: Graph, params, inputs, *, device,
           tensors: Sequence[str] | None = None, n_points: int = 10,
           seed: int = 0, chunk_batches: int = 25,
           share_key: Callable[[str], str] | None = None,
           labels: np.ndarray | None = None,
           include_fc: bool = True, mesh=None) -> FrozenCache:
    """Sample ground-truth responses of every conv top (default) on the
    calibration batches. The graph should have its ReLUs split
    (rewrite.split_relu) so conv outputs are addressable. Under a `mesh`
    (`device` its lead, `params` there) the calibration images are split
    over its shards (`sample_features`); one parameter copy is made per
    distinct device. The whole is the span `freeze` (utils/trace), with
    `sample_features`' spans `freeze.upload`, `freeze.forward` and
    `freeze.to_host` inside."""
    with trace.span("freeze"):
        chunk_batches = clamp_chunk_for_hbm(graph, int(inputs.shape[1]),
                                            chunk_batches)
        if tensors is None:
            tensors = freeze_tensor_set(graph, include_fc=include_fc)
        shapes = shapes_of(graph, batch=inputs.shape[1])
        plan = make_point_plan(shapes, tensors, inputs.shape[0], n_points,
                               seed, share_key=share_key)
        feats = sample_features(graph, params, inputs, plan, tensors,
                                device=device, chunk_batches=chunk_batches,
                                mesh=mesh, phase="freeze")
    if not isinstance(inputs, SyntheticInputs):
        inputs = np.asarray(inputs)
    return FrozenCache(inputs=inputs, plan=plan, feats=feats, labels=labels)


def channel_stats(graph: Graph, params, inputs, tensors: Sequence[str], *,
                  device, chunk_batches: int = 25
                  ) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Per-channel (mean, std) of each tensor over every image and spatial
    position of the calibration set (the measurement pass of the
    reference's add_bn). The set is cut into chunks as the freeze cuts it;
    each chunk's sums and sums of squares are reduced on `device` and
    accumulated in f64 on the host; the variance is floored at 1e-12."""
    tensors = tuple(tensors)
    input_name = graph.inputs[0].name
    sub = graph.ancestors_subgraph(tensors)
    chunk_batches = clamp_chunk_for_hbm(graph, int(inputs.shape[1]),
                                        chunk_batches)

    def tf(v):
        axes = (0, 2, 3) if v.dim() == 4 else (0,)
        return v.sum(dim=axes), (v * v).sum(dim=axes), v.numel() // v.shape[1]

    acc = {t: [0.0, 0.0, 0] for t in tensors}
    for lo, hi in _chunk_iter(inputs.shape[0], chunk_batches):
        x = device_chunk(inputs, lo, hi, device)
        _, caps = run_graph(sub, params, {input_name: x},
                            capture_transforms={t: tf for t in tensors})
        for t in tensors:
            s, ss, n = caps[t]
            acc[t][0] += s.cpu().numpy().astype(np.float64)
            acc[t][1] += ss.cpu().numpy().astype(np.float64)
            acc[t][2] += n
    out = {}
    for t, (s, ss, n) in acc.items():
        mean = s / n
        var = np.maximum(ss / n - mean ** 2, 1e-12)
        out[t] = (mean.astype(np.float32), np.sqrt(var).astype(np.float32))
    return out
