"""Synthetic calibration source (port of channel_pruning_tpu/sampling/inputs.py).

Each calibration batch i is unit normals drawn by a CPU `torch.Generator`
seeded from (seed, i), so any chunking of the set sees the same images and
the images do not depend on the device they are moved to. The JAX package
draws with threefry, which cannot be reproduced here: the spec is saved
under its own npz key (`SPEC_KEY`), and the frozen cache refuses the other
package's spec instead of replaying different images.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

SPEC_KEY = "inputs_spec_torch"
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
        x = torch.cat([inputs.batch(i) for i in range(lo, hi)], dim=0)
    else:
        x = torch.as_tensor(np.ascontiguousarray(
            np.asarray(inputs[lo:hi], np.float32)))
        x = x.reshape((-1,) + tuple(x.shape[2:]))
    return x.to(device)
