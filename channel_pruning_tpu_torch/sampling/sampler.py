"""Activation sampling and the frozen calibration cache (port of
channel_pruning_tpu/sampling/sampler.py).

* `freeze` / `sample_features`: one chunked forward over the calibration
  set captures every requested tensor and gathers its sampled channel
  vectors on the device as each tensor is produced;
* `sample_patches`: replay the current graph up to a conv's bottom and
  gather its (N, c, kh, kw) input patches at the planned output points;
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

from channel_pruning_tpu.graph.ir import Graph, LT, shapes_of
from channel_pruning_tpu_torch.ops.forward import run_graph
from channel_pruning_tpu_torch.ops.patches import (gather_channels_grouped,
                                                   gather_patches_grouped)
from channel_pruning_tpu_torch.sampling.inputs import (JAX_SPEC_KEY, SPEC_KEY,
                                                       SyntheticInputs,
                                                       device_chunk)


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


def sample_features(graph: Graph, params, inputs,
                    plan: Mapping[str, tuple[np.ndarray, np.ndarray]],
                    tensors: Sequence[str], *, device,
                    chunk_batches: int = 25) -> dict[str, np.ndarray]:
    """Ground-truth response sampling: {tensor: (n_batches*P*bs, C)} (dense
    (n_images, D) for non-spatial tensors). inputs: (n_batches, bs, C, H, W)
    host array or SyntheticInputs; params on `device`."""
    tensors = tuple(tensors)
    input_name = graph.inputs[0].name
    sub = graph.ancestors_subgraph(tensors)     # skip layers past the captures
    outs: dict[str, list[torch.Tensor]] = {t: [] for t in tensors}
    for lo, hi in _chunk_iter(inputs.shape[0], chunk_batches):
        x = device_chunk(inputs, lo, hi, device)
        pts = {t: _plan_slice(plan, t, lo, hi, device) for t in tensors}

        def make_tf(t):
            def tf(v):
                ys, xs = pts[t]
                if v.dim() != 4 or ys.shape[1] == 0:
                    return v.reshape(v.shape[0], -1)
                return gather_channels_grouped(v, ys, xs)
            return tf

        _, caps = run_graph(sub, params, {input_name: x},
                            capture_transforms={t: make_tf(t) for t in tensors})
        for t in tensors:
            outs[t].append(caps[t])
    return {t: torch.cat(v, dim=0).cpu().numpy() for t, v in outs.items()}


def sample_patches(graph: Graph, params, inputs, conv: str,
                   plan: Mapping[str, tuple[np.ndarray, np.ndarray]], *,
                   device, chunk_batches: int = 25) -> torch.Tensor:
    """Replay the current graph and gather the (N, c, kh, kw) input patches
    of `conv` at its planned output points; stays on `device`."""
    l = graph.layer(conv)
    geo = l.conv_geometry()
    bottom, top = l.bottoms[0], l.tops[0]
    kern = ((geo["kh"], geo["kw"]), (geo["sh"], geo["sw"]), (geo["ph"], geo["pw"]))
    input_name = graph.inputs[0].name
    sub = graph.ancestors_subgraph((bottom,))   # replay only up to `bottom`
    outs = []
    for lo, hi in _chunk_iter(inputs.shape[0], chunk_batches):
        x = device_chunk(inputs, lo, hi, device)
        ys, xs = _plan_slice(plan, top, lo, hi, device)
        _, caps = run_graph(
            sub, params, {input_name: x},
            capture_transforms={bottom: lambda v: gather_patches_grouped(
                v, ys, xs, *kern)})
        outs.append(caps[bottom])
    return torch.cat(outs, dim=0)


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
           include_fc: bool = True) -> FrozenCache:
    """Sample ground-truth responses of every conv top (default) on the
    calibration batches. The graph should have its ReLUs split
    (rewrite.split_relu) so conv outputs are addressable."""
    chunk_batches = clamp_chunk_for_hbm(graph, int(inputs.shape[1]),
                                        chunk_batches)
    if tensors is None:
        tensors = freeze_tensor_set(graph, include_fc=include_fc)
    shapes = shapes_of(graph, batch=inputs.shape[1])
    plan = make_point_plan(shapes, tensors, inputs.shape[0], n_points, seed,
                           share_key=share_key)
    feats = sample_features(graph, params, inputs, plan, tensors,
                            device=device, chunk_batches=chunk_batches)
    if not isinstance(inputs, SyntheticInputs):
        inputs = np.asarray(inputs)
    return FrozenCache(inputs=inputs, plan=plan, feats=feats, labels=labels)
