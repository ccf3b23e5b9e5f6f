"""Device meshes (port of channel_pruning_tpu/parallel/mesh.py).

One process owns every local card, as one JAX controller owns every local
device. A `Mesh` is an ordered tuple of shards, each a `torch.device`; a
device may appear more than once (logical shards on one card, as the JAX
tests run 8 virtual CPU devices), so the same code runs a mesh of 4 shards
on one H100 and a mesh of 8 cards. Two plans use it:

  * data: a batch (finetune, eval, the sampling forward, the rolling
    frontier) is split by images over the shards;
  * sample rows: the solver's N-row matrices are split by rows, each shard
    reduces its own rows (ZᵀZ, Zᵀy, XᵀX, XᵀY), and the partials are summed
    on the lead device, `devices[0]`, in shard order (fixed order: the sum
    is deterministic, and no atomics are involved).

A partial copied to the lead waits for its own device's stream: PyTorch's
cross-device `copy_` orders itself against both devices' current streams.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch


def _canonical(d) -> torch.device:
    """`cuda` -> `cuda:<current>`, so equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of shards; `devices[0]` is the lead, where partials
    are reduced and the solvers' small problems run."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        object.__setattr__(self, "devices",
                           tuple(_canonical(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """Each physical device once, in first-appearance order."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n: int | None = None, device=None) -> Mesh:
    """Every visible CUDA device (or the first `n`); with `device`, `n`
    logical shards on that one device (default 1)."""
    if device is not None:
        return Mesh((torch.device(device),) * (n or 1))
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("make_mesh() needs a CUDA device; pass device= "
                           "for logical shards on one device")
    n = n or count
    if n > count:
        raise ValueError(f"{n} devices requested, {count} visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def is_sharded(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.size > 1


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0
                    ) -> tuple[np.ndarray, int]:
    """Zero-pad axis length to a device-count multiple. Returns (padded,
    original_length)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, rem)
    return np.pad(x, pads), n


def shard_bounds(n: int, mesh: Mesh) -> list[tuple[int, int]]:
    """[lo, hi) of each shard's real rows when `n` rows are zero-padded to
    a multiple of the shard count and split evenly: shard s holds padded
    rows [s * per, (s + 1) * per), of which [lo, hi) are real (hi may equal
    lo: a shard of padding only)."""
    per = -(-n // mesh.size)
    return [(min(s * per, n), min((s + 1) * per, n)) for s in range(mesh.size)]


def shard_rows(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Split the leading axis of `x` into per-shard slices of equal length,
    zero-padded to a multiple of the shard count, each on its shard's
    device. On the device `x` already lives on, a slice of real rows is a
    view."""
    n = x.shape[0]
    per = -(-n // mesh.size)
    out = []
    for (lo, hi), dev in zip(shard_bounds(n, mesh), mesh.devices):
        part = x[lo:hi]
        if hi - lo < per:
            part = torch.cat([part, part.new_zeros((per - (hi - lo),)
                                                   + tuple(x.shape[1:]))])
        out.append(part.to(dev, non_blocking=True))
    return out


def real_rows(parts: Sequence[torch.Tensor], n: int, mesh: Mesh
              ) -> list[torch.Tensor]:
    """The real rows of each shard of `shard_rows` (views, padding left
    out)."""
    return [p[:hi - lo] for p, (lo, hi) in zip(parts, shard_bounds(n, mesh))]


def reduce_sum(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Σ parts on the lead device, added in shard order."""
    acc = parts[0].to(mesh.lead)
    for p in parts[1:]:
        acc = acc + p.to(mesh.lead)
    return acc


def gather_rows(parts: Sequence[torch.Tensor], mesh: Mesh,
                n: int | None = None) -> torch.Tensor:
    """The shards' rows concatenated in shard order on the lead device,
    cut to the first `n` (the padding dropped)."""
    out = torch.cat([p.to(mesh.lead) for p in parts], dim=0)
    return out if n is None else out[:n]


def replicate(params: Mapping[str, Mapping[str, torch.Tensor]], mesh: Mesh
              ) -> dict[torch.device, dict]:
    """{device: params} with one copy of `params` per distinct device of
    the mesh, made once; the lead's is `params` itself."""
    out = {}
    for d in mesh.distinct:
        out[d] = params if d == mesh.lead else {
            k: {kk: v.to(d) for kk, v in p.items()} for k, p in params.items()}
    return out
