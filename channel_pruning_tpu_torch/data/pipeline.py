"""Input pipeline (port of channel_pruning_tpu/data/pipeline.py): the Caffe
fork's ImageData transform — bicubic shorter-side resize, center (or
random) crop, BGR mean subtraction — plus the imagefolder reader, the
in-memory replay and the calibration materialiser.

The resize is the JAX package's `jax.image.resize(..., "bicubic",
antialias=False)`: Keys' cubic kernel with a = -0.5, weights renormalised
where the 4 taps leave the image, written here as one (out, in) weight
matrix per axis and applied as two matmuls. `F.interpolate(mode="bicubic")`
is another resize (a = -0.75, edges clamped) and is not used.

Images flow through the net as BGR with the mean pixel subtracted, no
scaling to [0, 1]. PIL is imported only where images are decoded.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np
import torch

# Caffe ilsvrc mean pixel in BGR order
BGR_MEAN = np.array([103.939, 116.779, 123.68], np.float32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of the bicubic (a = -0.5) resize of one
    axis, following jax.image's scale-and-translate without antialiasing:
    sample i sits at (i + 0.5) * n_in / n_out - 0.5, each column of weights
    is renormalised to sum 1, and samples outside [-0.5, n_in - 0.5] get 0."""
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float32)
    inv_scale = np.float32(1.0) / np.float32(n_out / n_in)
    sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale
              - np.float32(0.5))
    w = _keys_cubic(np.abs(sample[None, :]
                           - np.arange(n_in, dtype=np.float32)[:, None]))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32).T.copy()


def _resized_shape(h: int, w: int, new_dim: int) -> tuple[int, int]:
    if h <= w:
        return new_dim, max(int(round(w * new_dim / h)), new_dim)
    return max(int(round(h * new_dim / w)), new_dim), new_dim


def preprocess(img, *, new_dim: int = 256, crop: int = 224,
               random_crop: bool = False,
               generator: torch.Generator | None = None,
               mean=None) -> torch.Tensor:
    """uint8/float RGB HWC image (numpy or CPU tensor) -> float32 BGR CHW
    tensor: bicubic shorter-side resize to `new_dim` (aspect kept), center
    crop `crop` (a random crop drawn from `generator` with `random_crop`),
    `mean` (BGR pixel, or an (H, W, C) image) subtracted."""
    x = torch.as_tensor(np.ascontiguousarray(img, np.float32))
    h, w = x.shape[0], x.shape[1]
    nh, nw = _resized_shape(h, w, new_dim)
    rh = torch.from_numpy(resize_matrix(h, nh))
    rw = torch.from_numpy(resize_matrix(w, nw))
    x = torch.einsum("oh,hwc->owc", rh, x)
    x = torch.einsum("pw,owc->opc", rw, x)
    if random_crop and generator is not None:
        y0 = int(torch.randint(0, nh - crop + 1, (), generator=generator))
        x0 = int(torch.randint(0, nw - crop + 1, (), generator=generator))
    else:
        y0, x0 = (nh - crop) // 2, (nw - crop) // 2
    x = x[y0:y0 + crop, x0:x0 + crop].flip(-1)          # RGB -> BGR
    m = torch.from_numpy(BGR_MEAN if mean is None else np.asarray(mean, np.float32))
    return (x - m).permute(2, 0, 1).contiguous()


def load_mean_file(path: str | Path) -> np.ndarray:
    """A mean array saved as .npy (CHW or pixel)."""
    return np.load(path).astype(np.float32)


def load_binaryproto_mean(path: str | Path,
                          crop: int | None = None) -> np.ndarray:
    """Decode a Caffe mean .binaryproto (BlobProto) to a float32 (C, H, W)
    array; with `crop`, center-crop it to (C, crop, crop), since the mean is
    subtracted after the crop."""
    from channel_pruning_tpu_torch.io.caffemodel import _decode_blob

    arr = np.asarray(_decode_blob(memoryview(Path(path).read_bytes())),
                     np.float32)
    while arr.ndim > 3 and arr.shape[0] == 1:
        arr = arr[0]
    if crop is not None and arr.ndim == 3:
        h, w = arr.shape[1], arr.shape[2]
        y0, x0 = (h - crop) // 2, (w - crop) // 2
        arr = arr[:, y0:y0 + crop, x0:x0 + crop]
    return arr


def as_pixel_mean(mean: np.ndarray) -> np.ndarray:
    """(C, H, W) mean image -> (H, W, C) for `preprocess`; (C,) stays."""
    if mean.ndim == 3:
        return np.transpose(mean, (1, 2, 0))
    return mean


def _list_imagefolder(root: Path) -> tuple[list[Path], list[int], list[str]]:
    classes = sorted(p.name for p in root.iterdir() if p.is_dir())
    cls_idx = {c: i for i, c in enumerate(classes)}
    files, labels = [], []
    for c in classes:
        for f in sorted((root / c).iterdir()):
            if f.suffix.lower() in (".jpg", ".jpeg", ".png", ".bmp"):
                files.append(f)
                labels.append(cls_idx[c])
    return files, labels, classes


def _decode_rgb(path: Path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def imagefolder_batches(root: str | Path, batch: int, *, new_dim: int = 256,
                        crop: int = 224, shuffle: bool = False, seed: int = 0,
                        loop: bool = False, random_crop: bool = False,
                        mean: np.ndarray | None = None
                        ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (x (B, 3, crop, crop) float32 BGR, y (B,) int32) from a
    class-per-directory tree; the order shuffles with numpy from `seed`,
    random crops come from a torch.Generator seeded with it."""
    root = Path(root)
    files, labels, _ = _list_imagefolder(root)
    order = np.arange(len(files))
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    while True:
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - batch + 1, batch):
            xs = [preprocess(_decode_rgb(files[j]), new_dim=new_dim, crop=crop,
                             random_crop=random_crop, generator=gen,
                             mean=mean).numpy() for j in order[i:i + batch]]
            yield np.stack(xs), np.asarray([labels[j] for j in order[i:i + batch]],
                                           np.int32)
        if not loop:
            return


def preload_imagefolder(root: str | Path, *, new_dim: int = 256,
                        crop: int = 224, mean: np.ndarray | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Decode and preprocess a whole imagefolder once (center crops) into
    host arrays X (N, 3, crop, crop) float32 and y (N,) int32."""
    files, labels, _ = _list_imagefolder(Path(root))
    xs = [preprocess(_decode_rgb(f), new_dim=new_dim, crop=crop,
                     mean=mean).numpy() for f in files]
    return np.stack(xs), np.asarray(labels, np.int32)


def memory_batches(X: np.ndarray, y: np.ndarray, batch: int, *,
                   shuffle: bool = False, seed: int = 0, loop: bool = False
                   ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (x, y) batches from preloaded arrays (numpy shuffle, as the
    JAX package draws it)."""
    order = np.arange(len(X))
    rng = np.random.default_rng(seed)
    while True:
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - batch + 1, batch):
            sel = order[i:i + batch]
            yield X[sel], y[sel]
        if not loop:
            return


def calibration_batches(source, n_batches: int, batch: int,
                        image: int = 224) -> tuple[np.ndarray, np.ndarray | None]:
    """Materialise (n_batches, batch, 3, H, W) calibration inputs and their
    labels from any (x, y) iterator."""
    xs, ys = [], []
    for i, (x, y) in enumerate(source):
        if i >= n_batches:
            break
        xs.append(x)
        ys.append(y)
    inputs = np.stack(xs)
    labels = np.stack(ys) if ys and ys[0] is not None else None
    return inputs, labels
