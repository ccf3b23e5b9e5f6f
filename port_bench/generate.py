"""Inputs made from seeds: the weights, the calibration sets and the
held-out batch. Each comes from its own torch.Generator on the run's
device, in a few large draws, and goes to the host as the numpy arrays the
program's API takes. The same seeds give the same values on one device.

A compression job's work (its CD sweeps and grids, the channels kept)
depends on the weights and on each image and its place in the set (the
point plan is drawn per batch), so the problem (the weights, the pool of
calibration sets, the held-out images) is drawn from the configuration's
`problem_seed`, and the run's seed draws only the order in which the jobs
cycle through the pool (`pool_order`): every run does the same work, in
another order, and judges the same problem. The limits of the check are
read over a dozen problems drawn from other seeds (control.py)."""
from __future__ import annotations

import numpy as np
import torch

from port_bench import shapes as shp

WEIGHTS, CALIBRATION, HELD_OUT, ORDER = 1, 2, 3, 4


def sub_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed for one stream of draws from the run's seed."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *salt])
    return int(ss.generate_state(1, np.uint64)[0] & 0x7FFF_FFFF_FFFF_FFFF)


def _gen(device, seed: int, *salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *salt))


def weights(layers: list[dict], input_shape: tuple[int, ...], seed: int,
            device) -> dict[str, dict[str, np.ndarray]]:
    """He-normal conv and inner-product weights (std sqrt(2 / fan_in)), in
    one draw; zero biases; BatchNorm mean 0, variance 1, factor 1; Scale 1
    and 0. Caffe layouts: conv W (out, in / group, kh, kw), fc W (out, in)."""
    tshape = shp.tensor_shapes(layers, input_shape)
    specs = []                       # (layer, W shape, fan_in)
    for l in layers:
        a = l["attrs"]
        if l["type"] == "Convolution":
            g = shp.conv_geometry(a)
            cin = tshape[l["bottoms"][0]][1] // g["group"]
            specs.append((l["name"], (int(a["num_output"]), cin, g["kh"], g["kw"]),
                          cin * g["kh"] * g["kw"]))
        elif l["type"] == "InnerProduct":
            fan_in = int(np.prod(tshape[l["bottoms"][0]][1:]))
            specs.append((l["name"], (int(a["num_output"]), fan_in), fan_in))
    total = sum(int(np.prod(s)) for _, s, _ in specs)
    flat = torch.randn(total, generator=_gen(device, seed, WEIGHTS),
                       device=device, dtype=torch.float32)
    off = 0
    for _, s, fan_in in specs:
        n = int(np.prod(s))
        flat[off:off + n].mul_((2.0 / fan_in) ** 0.5)
        off += n
    host = flat.cpu().numpy()
    params: dict[str, dict[str, np.ndarray]] = {}
    off = 0
    for name, s, _ in specs:
        n = int(np.prod(s))
        params[name] = {"W": host[off:off + n].reshape(s),
                        "b": np.zeros(s[0], np.float32)}
        off += n
    for l in layers:
        if l["type"] in ("BatchNorm", "Scale"):
            c = tshape[l["bottoms"][0]][1]
            params[l["name"]] = (
                {"mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32),
                 "factor": np.ones((), np.float32)} if l["type"] == "BatchNorm"
                else {"W": np.ones(c, np.float32), "b": np.zeros(c, np.float32)})
    return params


def calibration_set(shape: tuple[int, ...], problem_seed: int, k: int,
                    device) -> np.ndarray:
    """Calibration set k of the pool, (n_batches, batch, C, H, W): unit
    normal images drawn from `problem_seed`."""
    x = torch.randn(shape, generator=_gen(device, problem_seed, CALIBRATION, k),
                    device=device, dtype=torch.float32)
    return x.cpu().numpy()


def pool_order(n: int, seed: int) -> list[int]:
    """The order in which the jobs cycle through a pool of n sets, drawn
    from the run's seed (on the host, so that it is the same on any
    device)."""
    return [int(i) for i in np.random.default_rng(sub_seed(seed, ORDER)).permutation(n)]


def held_out(n: int, sample_shape: tuple[int, ...], seed: int,
             device) -> torch.Tensor:
    """The held-out images the compressed model is judged on: unit normals
    from a stream no calibration set draws from."""
    return torch.randn((n,) + tuple(sample_shape),
                       generator=_gen(device, seed, HELD_OUT),
                       device=device, dtype=torch.float32)
