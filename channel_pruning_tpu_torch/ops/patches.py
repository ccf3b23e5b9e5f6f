"""Point-wise activation and patch gathers (port of
channel_pruning_tpu/ops/patches.py).

Row-order contract: for a chunk of B images and P points, rows are
point-major, row = p * B + b. The grouped variants take G chunks of B
images stacked along the image axis with per-chunk points (G, P) and
return the chunks' rows concatenated in order (row = g*P*B + p*B + b).
The per-image variants take each image's own points and return (n, P, ...)
for a shard of a chunk's images; `image_rows` puts the shards' gathers,
concatenated, back in the grouped order. Pure indexing and a 0/1 mask
multiply, so the outputs are bit-equal to the JAX package's.
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
    """v: (G*B, C, H, W), ys/xs: (G, P) -> (G*P*B, C): one indexing op for
    all G chunks (the values and rows of G calls of
    gather_channels_at_points, concatenated)."""
    G = ys.shape[0]
    vg = v.reshape((G, -1) + tuple(v.shape[1:]))           # (G, B, C, H, W)
    gi = torch.arange(G, device=v.device)[:, None]
    # advanced indices on dims 0, 3, 4 around slices: (G, P) lead, (B, C)
    return vg[gi, :, :, ys, xs].reshape(-1, v.shape[1])


def gather_patches_grouped(v: torch.Tensor, ys: torch.Tensor,
                           xs: torch.Tensor, kernel: tuple[int, int],
                           stride: tuple[int, int], pad: tuple[int, int]
                           ) -> torch.Tensor:
    """v: (G*B, C, H, W), ys/xs: (G, P) -> (G*P*B, C, kh, kw): one gather
    for all G chunks (the values and rows of G calls of
    gather_patches_at_points, concatenated; a host loop over the chunks
    cost ~18 small ops each)."""
    kh, kw = kernel
    sh, sw = stride
    ph, pw = pad
    G, H, W = ys.shape[0], v.shape[2], v.shape[3]
    dev = v.device
    vg = v.reshape((G, -1) + tuple(v.shape[1:]))           # (G, B, C, H, W)
    rows = (ys * sh - ph)[:, :, None] + torch.arange(kh, device=dev)
    cols = (xs * sw - pw)[:, :, None] + torch.arange(kw, device=dev)
    rmask = (rows >= 0) & (rows < H)                        # (G, P, kh)
    cmask = (cols >= 0) & (cols < W)                        # (G, P, kw)
    rc = rows.clamp(0, H - 1)[:, :, :, None]
    cc = cols.clamp(0, W - 1)[:, :, None, :]
    gi = torch.arange(G, device=dev)[:, None, None, None]
    sub = vg[gi, :, :, rc, cc]                          # (G, P, kh, kw, B, C)
    mask = (rmask[:, :, :, None] & cmask[:, :, None, :]).to(v.dtype)
    sub = sub * mask[..., None, None]
    return sub.permute(0, 1, 4, 5, 2, 3).reshape(-1, v.shape[1], kh, kw)


def gather_channels_per_image(v: torch.Tensor, ys: torch.Tensor,
                              xs: torch.Tensor) -> torch.Tensor:
    """v: (n, C, H, W), ys/xs: (n, P) each image's own points -> (n, P, C)
    (the form an image-sharded capture takes before `image_rows`)."""
    ii = torch.arange(v.shape[0], device=v.device)[:, None]
    return v[ii, :, ys, xs]


def gather_patches_per_image(v: torch.Tensor, ys: torch.Tensor,
                             xs: torch.Tensor, kernel: tuple[int, int],
                             stride: tuple[int, int], pad: tuple[int, int]
                             ) -> torch.Tensor:
    """v: (n, C, H, W), ys/xs: (n, P) each image's own output points ->
    (n, P, C, kh, kw), with the clamp + mask of `gather_patches_grouped`
    (so the values are bit-equal to it)."""
    kh, kw = kernel
    sh, sw = stride
    ph, pw = pad
    H, W = v.shape[2], v.shape[3]
    dev = v.device
    rows = (ys * sh - ph)[:, :, None] + torch.arange(kh, device=dev)
    cols = (xs * sw - pw)[:, :, None] + torch.arange(kw, device=dev)
    rmask = (rows >= 0) & (rows < H)                        # (n, P, kh)
    cmask = (cols >= 0) & (cols < W)                        # (n, P, kw)
    rc = rows.clamp(0, H - 1)[:, :, :, None]
    cc = cols.clamp(0, W - 1)[:, :, None, :]
    ii = torch.arange(v.shape[0], device=dev)[:, None, None, None]
    sub = v[ii, :, rc, cc]                              # (n, P, kh, kw, C)
    mask = (rmask[:, :, :, None] & cmask[:, :, None, :]).to(v.dtype)
    sub = sub * mask[..., None]
    return sub.permute(0, 1, 4, 2, 3)


def image_rows(t: torch.Tensor, batch: int) -> torch.Tensor:
    """Per-image gathers (G*B, P, ...) of G chunks of B images -> the rows
    of the grouped gathers, row = g*P*B + p*B + b."""
    G = t.shape[0] // batch
    rest = tuple(t.shape[2:])
    return t.reshape((G, batch) + tuple(t.shape[1:])).transpose(1, 2) \
        .reshape((-1,) + rest)
