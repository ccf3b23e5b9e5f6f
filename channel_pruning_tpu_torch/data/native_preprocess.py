"""ctypes binding for the native (C++/OpenMP) input-pipeline kernels (port
of channel_pruning_tpu/data/native_preprocess.py).

csrc/preprocess.cpp (a byte-for-byte copy of native/preprocess.cpp) is the
Caffe fork's ImageData hot path: bicubic shorter-side resize, crop and BGR
mean subtraction, images in parallel under OpenMP. It is built with g++ at
first use (utils/native); a failed build or load raises. The readers do not
call it (no JAX path does either); it is held to `data.pipeline.preprocess`
by the tests.
"""
from __future__ import annotations

import ctypes

import numpy as np

from channel_pruning_tpu_torch.data.pipeline import BGR_MEAN
from channel_pruning_tpu_torch.utils import native

SOURCE = native.CSRC / "preprocess.cpp"
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = native.build(SOURCE)
        i32, fptr = ctypes.c_int, ctypes.POINTER(ctypes.c_float)
        lib.cp_preprocess_image.restype = i32
        lib.cp_preprocess_image.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), i32, i32, i32, i32, i32, i32, i32,
            fptr, fptr]
        lib.cp_preprocess_batch.restype = i32
        lib.cp_preprocess_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), i32, i32, i32, i32, i32, i32,
            ctypes.POINTER(i32), fptr, fptr]
        lib.cp_num_threads.restype = i32
        _lib = lib
    return _lib


def num_threads() -> int:
    return _load().cp_num_threads()


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def preprocess_image(img: np.ndarray, *, new_dim: int = 256, crop: int = 224,
                     crop_yx: tuple[int, int] = (-1, -1),
                     mean: np.ndarray | None = None) -> np.ndarray:
    """uint8 RGB HWC -> float32 BGR CHW; `crop_yx` (-1, -1) is the centre
    crop."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, ch = img.shape
    m = np.ascontiguousarray(BGR_MEAN if mean is None else mean, np.float32)
    out = np.empty((3, crop, crop), np.float32)
    rc = lib.cp_preprocess_image(_u8ptr(img), h, w, ch, new_dim, crop,
                                 crop_yx[0], crop_yx[1], _fptr(m), _fptr(out))
    if rc != 0:
        raise ValueError(f"cp_preprocess_image failed rc={rc} (h={h}, w={w})")
    return out


def preprocess_batch(imgs: np.ndarray, *, new_dim: int = 256, crop: int = 224,
                     crop_yx: np.ndarray | None = None,
                     mean: np.ndarray | None = None) -> np.ndarray:
    """uint8 RGB NHWC (one size) -> float32 BGR NCHW, images in parallel;
    `crop_yx` (N, 2) per-image crop corners, centre crops without it."""
    lib = _load()
    imgs = np.ascontiguousarray(imgs, np.uint8)
    n, h, w, ch = imgs.shape
    m = np.ascontiguousarray(BGR_MEAN if mean is None else mean, np.float32)
    out = np.empty((n, 3, crop, crop), np.float32)
    cyx_ptr = ctypes.POINTER(ctypes.c_int)()
    if crop_yx is not None:
        cyx = np.ascontiguousarray(crop_yx, np.int32)
        cyx_ptr = cyx.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    rc = lib.cp_preprocess_batch(_u8ptr(imgs), n, h, w, ch, new_dim, crop,
                                 cyx_ptr, _fptr(m), _fptr(out))
    if rc != 0:
        raise ValueError(f"cp_preprocess_batch failed rc={rc}")
    return out
