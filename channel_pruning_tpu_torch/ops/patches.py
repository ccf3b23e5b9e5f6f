"""Point-wise activation and patch gathers (port of
channel_pruning_tpu/ops/patches.py).

Row-order contract: for a chunk of B images and P points, rows are
point-major, row = p * B + b. The grouped variants take G chunks of B
images stacked along the image axis with per-chunk points (G, P) and
return the chunks' rows concatenated in order (row = g*P*B + p*B + b).
Pure indexing and a 0/1 mask multiply, so the outputs are bit-equal to the
JAX package's.
"""
from __future__ import annotations

import torch


def gather_channels_at_points(x: torch.Tensor, ys: torch.Tensor,
                              xs: torch.Tensor) -> torch.Tensor:
    """x: (B, C, H, W); ys/xs: (P,) int. Returns (P*B, C)."""
    sub = x[:, :, ys, xs]                                  # (B, C, P)
    return sub.permute(2, 0, 1).reshape(-1, x.shape[1])


def gather_patches_at_points(x: torch.Tensor, ys: torch.Tensor,
                             xs: torch.Tensor, kernel: tuple[int, int],
                             stride: tuple[int, int], pad: tuple[int, int]
                             ) -> torch.Tensor:
    """The k x k input patch feeding each sampled output point of a conv.
    x: (B, C, H, W) the conv's input; ys/xs: (P,) output coordinates.
    Returns (P*B, C, kh, kw). Zero padding is clamp + mask, so no padded
    copy of x is made (x may be the whole-set frontier)."""
    kh, kw = kernel
    sh, sw = stride
    ph, pw = pad
    H, W = x.shape[2], x.shape[3]
    dev = x.device
    rows = (ys * sh - ph)[:, None] + torch.arange(kh, device=dev)[None, :]
    cols = (xs * sw - pw)[:, None] + torch.arange(kw, device=dev)[None, :]
    rmask = (rows >= 0) & (rows < H)
    cmask = (cols >= 0) & (cols < W)
    rc = rows.clamp(0, H - 1)
    cc = cols.clamp(0, W - 1)
    sub = x[:, :, rc[:, :, None], cc[:, None, :]]          # (B, C, P, kh, kw)
    mask = (rmask[:, :, None] & cmask[:, None, :]).to(x.dtype)
    sub = sub * mask[None, None]
    return sub.permute(2, 0, 1, 3, 4).reshape(-1, x.shape[1], kh, kw)


def gather_channels_grouped(v: torch.Tensor, ys: torch.Tensor,
                            xs: torch.Tensor) -> torch.Tensor:
    """v: (G*B, C, H, W), ys/xs: (G, P) -> (G*P*B, C)."""
    G = ys.shape[0]
    vg = v.reshape((G, -1) + tuple(v.shape[1:]))
    return torch.cat([gather_channels_at_points(vg[g], ys[g], xs[g])
                      for g in range(G)], dim=0)


def gather_patches_grouped(v: torch.Tensor, ys: torch.Tensor,
                           xs: torch.Tensor, kernel: tuple[int, int],
                           stride: tuple[int, int], pad: tuple[int, int]
                           ) -> torch.Tensor:
    """v: (G*B, C, H, W), ys/xs: (G, P) -> (G*P*B, C, kh, kw)."""
    G = ys.shape[0]
    vg = v.reshape((G, -1) + tuple(v.shape[1:]))
    return torch.cat([gather_patches_at_points(vg[g], ys[g], xs[g], kernel,
                                               stride, pad)
                      for g in range(G)], dim=0)
