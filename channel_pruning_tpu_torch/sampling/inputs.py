"""Synthetic calibration source (port of channel_pruning_tpu/sampling/inputs.py).

Each calibration batch i is unit normals drawn by a CPU `torch.Generator`
seeded from (seed, i), so any chunking of the set sees the same images and
the images do not depend on the device they are moved to. For a card, a
set of up to `PIN_BUDGET` bytes is drawn whole once into pinned host memory
(`SyntheticInputs.pinned`, kept while the object lives) and each chunk is
copied from there without blocking the host: a run that replays the set
for every layer (the Faster-RCNN backbone at 600²) draws it once, not once
a layer. The JAX package
draws with threefry, which cannot be reproduced here: the spec is saved
under its own npz key (`SPEC_KEY`), and the frozen cache refuses the other
package's spec instead of replaying different images.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

SPEC_KEY = "inputs_spec_torch"
PIN_BUDGET = 4 << 30      # bytes of a set drawn whole into pinned memory
JAX_SPEC_KEY = "inputs_spec"


def _batch_seed(seed: int, i: int) -> int:
    return int(np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0]
               & 0x7FFF_FFFF_FFFF_FFFF)


@dataclass(frozen=True)
class SyntheticInputs:
    """A (n_batches, bs, *sample_shape) calibration set that exists only as
    a seed; batches are generated on demand."""

    n_batches: int
    bs: int
    sample_shape: tuple[int, ...]          # (C, H, W)
    seed: int = 0

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.n_batches, self.bs) + tuple(self.sample_shape)

    def batch(self, i: int) -> torch.Tensor:
        gen = torch.Generator(device="cpu").manual_seed(_batch_seed(self.seed, i))
        return torch.randn((self.bs,) + tuple(self.sample_shape), generator=gen,
                           dtype=torch.float32)

    @functools.cached_property
    def pinned(self) -> torch.Tensor | None:
        """The whole set, (n_batches*bs, C, H, W), drawn once into pinned
        host memory and kept while this object lives; None for a set
        larger than PIN_BUDGET."""
        shape = (self.n_batches * self.bs,) + tuple(self.sample_shape)
        if 4 * int(np.prod(shape)) > PIN_BUDGET:
            return None
        host = torch.empty(shape, dtype=torch.float32, pin_memory=True)
        for i in range(self.n_batches):
            host[i * self.bs:(i + 1) * self.bs] = self.batch(i)
        return host

    def spec(self) -> np.ndarray:
        return np.asarray([self.n_batches, self.bs, self.seed]
                          + list(self.sample_shape), np.int64)

    @staticmethod
    def from_spec(spec: np.ndarray) -> "SyntheticInputs":
        spec = [int(v) for v in np.asarray(spec)]
        return SyntheticInputs(n_batches=spec[0], bs=spec[1], seed=spec[2],
                               sample_shape=tuple(spec[3:]))


def device_chunk(inputs, lo: int, hi: int, device) -> torch.Tensor:
    """Batches [lo, hi) of a calibration source (host array or
    SyntheticInputs) as a flat ((hi-lo)*bs, C, H, W) tensor on `device`."""
    if isinstance(inputs, SyntheticInputs):
        host = inputs.pinned if torch.device(device).type == "cuda" else None
        if host is not None:
            return host[lo * inputs.bs:hi * inputs.bs].to(device,
                                                          non_blocking=True)
        x = torch.cat([inputs.batch(i) for i in range(lo, hi)], dim=0)
    else:
        x = torch.as_tensor(np.ascontiguousarray(
            np.asarray(inputs[lo:hi], np.float32)))
        x = x.reshape((-1,) + tuple(x.shape[2:]))
    return x.to(device)


def device_images(inputs, lo: int, hi: int, device) -> torch.Tensor:
    """Images [lo, hi) of the flattened (n_batches * bs) calibration set as
    one (hi-lo, C, H, W) tensor on `device` (a shard's share of a chunk:
    only its own images cross to its device)."""
    bs = int(inputs.shape[1])
    if isinstance(inputs, SyntheticInputs) and \
            torch.device(device).type == "cuda" and inputs.pinned is not None:
        return inputs.pinned[lo:hi].to(device, non_blocking=True)
    b0, b1 = lo // bs, -(-hi // bs)
    return device_chunk(inputs, b0, b1, "cpu")[lo - b0 * bs:hi - b0 * bs] \
        .to(device)
