"""Device choice and solver precision.

Takes over the role of the JAX package's `lstsq.f32_matmuls`
(channel_pruning_tpu/ops/lstsq.py:18-30): solver and replay math run in
full f32. On Hopper, cuDNN convolutions default to TF32, which keeps about
three decimal digits and would make the replays disagree with the
reference's f32 forward, so TF32 is switched off for matmuls and convs.
"""
from __future__ import annotations

import torch


def fp32_solver() -> None:
    """Full-f32 matmuls and convs, deterministic cuDNN algorithms (so the
    channel selections are byte-identical from run to run). Process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


def resolve_device(name: str) -> torch.device:
    """`"cuda"` (the default everywhere) requires a card and raises without
    one; `"cpu"` is used only when asked for by name — the default never
    quietly becomes the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                               "available; pass device='cpu' explicitly to "
                               "run on the host")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    fp32_solver()
    return dev
