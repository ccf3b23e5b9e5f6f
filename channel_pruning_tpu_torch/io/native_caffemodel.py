"""ctypes binding for the native caffemodel wire indexer (port of
channel_pruning_tpu/io/native_caffemodel.py).

csrc/caffemodel.cpp (a byte-for-byte copy of native/caffemodel.cpp) walks
the NetParameter wire format once and returns (layer, blob) records with
absolute data offsets; the float payloads are then wrapped zero-copy with
np.frombuffer. It mirrors io/caffemodel's Python walk (the same V1 enum
mapping and legacy-shape rules). The indexer returns -1 for a construct it
does not support (or a file it cannot parse): only then does the caller
fall back to the Python walk. The library is built with g++ at first use
(utils/native); a failed build or load raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from channel_pruning_tpu_torch.utils import native

SOURCE = native.CSRC / "caffemodel.cpp"
_REC = 12
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = native.build(SOURCE)
        lib.cp_caffemodel_index.restype = ctypes.c_int64
        lib.cp_caffemodel_index.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
    return _lib


def load_caffemodel_native(path: str | Path):
    """io.caffemodel.load_caffemodel through the indexer: (net_name,
    [CaffeLayerBlobs]), or None when the indexer returns -1."""
    from channel_pruning_tpu_torch.io.caffemodel import (_V1_TYPES,
                                                         CaffeLayerBlobs)

    lib = _load()
    raw = np.fromfile(str(path), dtype=np.uint8)
    n = raw.size
    bufp = raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    noff = ctypes.c_int64(-1)
    nlen = ctypes.c_int64(0)
    count = lib.cp_caffemodel_index(bufp, n, None, 0,
                                    ctypes.byref(noff), ctypes.byref(nlen))
    if count < 0:
        return None
    recs = np.zeros((int(count), _REC), np.int64)
    got = lib.cp_caffemodel_index(
        bufp, n, recs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        count, ctypes.byref(noff), ctypes.byref(nlen))
    if got != count:
        raise RuntimeError(f"{path}: the indexer counted {count} records, "
                           f"then wrote {got}")

    def _str(off, ln):
        return raw[off:off + ln].tobytes().decode("utf-8", "replace")

    net_name = _str(noff.value, nlen.value) if noff.value >= 0 else ""
    layers: list = []
    for rec in recs:
        if rec[0] == 0:                                   # layer
            name = _str(rec[1], rec[2]) if rec[1] >= 0 else ""
            if rec[5]:                                    # V1 enum type
                ltype = _V1_TYPES.get(int(rec[4]), f"V1_{int(rec[4])}")
            else:
                ltype = _str(rec[3], rec[4]) if rec[3] >= 0 else ""
            layers.append(CaffeLayerBlobs(name=name, type=ltype, blobs=[]))
            continue
        off, cnt, dtype, ndim = int(rec[1]), int(rec[2]), rec[3], int(rec[4])
        if off >= 0:
            data = np.frombuffer(raw, dtype="<f8" if dtype == 1 else "<f4",
                                 count=cnt, offset=off)
            if dtype == 1:
                data = data.astype(np.float32)
        else:
            data = np.zeros(0, np.float32)
        if ndim:
            data = data.reshape([int(d) for d in rec[5:5 + ndim]])
        if not layers:
            raise RuntimeError(f"{path}: the indexer gave a blob before any "
                               "layer")
        layers[-1].blobs.append(data)
    return net_name, layers
