"""Binary .caffemodel codec — a from-scratch protobuf wire-format reader and
writer for the handful of Caffe messages the pipeline needs.

The reference loads/saves weights through pycaffe (`caffe.Net(...).save()`,
lib/net.py:166-169). We decode the protobuf wire format directly instead of
generating bindings: a .caffemodel is a NetParameter message; we extract each
layer's name, type and blobs (weights). Field numbers below are the public
caffe.proto contract (BVLC Caffe, BSD):

  NetParameter:  name=1, layers(V1)=2, input=3, input_dim=4, layer=100
  LayerParameter: name=1, type=2, bottom=3, top=4, blobs=7
  V1LayerParameter: bottom=2, top=3, name=4, type=5(enum), blobs=6
  BlobProto: num=1, channels=2, height=3, width=4, data=5(packed float),
             shape=7, double_data=8 (diff=6 / double_diff=9 are skipped)
  BlobShape: dim=1 (packed int64)
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

import numpy as np


# ---------------------------------------------------------------------------
# generic wire format
# ---------------------------------------------------------------------------

def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def iter_fields(buf: memoryview) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value). Length-delimited values are
    memoryviews; varints ints; fixed32/64 raw ints."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            if pos + ln > n:
                raise ValueError(f"field {fnum}: {ln} bytes declared, "
                                 f"{n - pos} left (truncated file?)")
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} for field {fnum}")
        yield fnum, wt, val


def _tag(out: bytearray, fnum: int, wt: int) -> None:
    _write_varint(out, (fnum << 3) | wt)


def _put_bytes(out: bytearray, fnum: int, payload: bytes) -> None:
    _tag(out, fnum, 2)
    _write_varint(out, len(payload))
    out += payload


def _put_string(out: bytearray, fnum: int, s: str) -> None:
    _put_bytes(out, fnum, s.encode("utf-8"))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@dataclass
class CaffeLayerBlobs:
    name: str
    type: str
    blobs: list[np.ndarray] = field(default_factory=list)


def _decode_blob(buf: memoryview) -> np.ndarray:
    shape: list[int] = []
    legacy = {}
    data: np.ndarray | None = None
    for fnum, wt, val in iter_fields(buf):
        if fnum == 7 and wt == 2:  # shape: BlobShape
            dims = []
            for f2, w2, v2 in iter_fields(val):
                if f2 == 1:
                    if w2 == 2:  # packed
                        pos = 0
                        while pos < len(v2):
                            d, pos = _read_varint(v2, pos)
                            dims.append(d)
                    else:
                        dims.append(v2)
            shape = dims
        elif fnum == 5 and wt == 2:  # packed float data
            data = np.frombuffer(bytes(val), dtype="<f4")
        elif fnum == 5 and wt == 5:  # unpacked single float (rare)
            v = np.float32(struct.unpack("<f", struct.pack("<I", val))[0])
            data = np.append(data, v) if data is not None else np.array([v], "<f4")
        elif fnum == 8 and wt == 2:  # packed double data
            data = np.frombuffer(bytes(val), dtype="<f8").astype(np.float32)
        elif fnum in (6, 9) and wt == 2:
            pass  # diff (6) / double_diff (9): gradients, not weights
        elif fnum in (1, 2, 3, 4) and wt == 0:  # legacy num/channels/h/w
            legacy[fnum] = val
    if data is None:
        data = np.zeros(0, np.float32)
    if not shape and legacy:
        shape = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
    if shape:
        data = data.reshape(shape)
    return data


# V1LayerParameter.LayerType enum -> modern type strings (public caffe.proto)
_V1_TYPES = {
    3: "Concat", 4: "Convolution", 5: "Data", 6: "Dropout", 8: "Eltwise",
    14: "InnerProduct", 15: "LRN", 17: "Pooling", 18: "ReLU", 20: "Softmax",
    21: "SoftmaxWithLoss", 22: "Split", 1: "Accuracy", 33: "Slice",
    39: "DeconvolutionLayer", 12: "ImageData", 29: "MemoryData", 36: "Threshold",
}


# loads that took the Python walk because the native indexer returned -1
native_fallbacks = 0


def load_caffemodel(path: str | Path) -> tuple[str, list[CaffeLayerBlobs]]:
    """Return (net name, ordered layer blob records) from a .caffemodel.

    The native wire indexer first (io/native_caffemodel, built with g++ at
    first use); the Python walk `load_caffemodel_python` only where the
    indexer returns -1 for a construct it does not support, and each such
    load counts in `native_fallbacks`. A failed build or load of the
    native library raises."""
    global native_fallbacks
    from channel_pruning_tpu_torch.io.native_caffemodel import \
        load_caffemodel_native

    res = load_caffemodel_native(path)
    if res is not None:
        return res
    native_fallbacks += 1
    return load_caffemodel_python(path)


def load_caffemodel_python(path: str | Path
                           ) -> tuple[str, list[CaffeLayerBlobs]]:
    """`load_caffemodel` by a pure-Python field walk (packed float payloads
    are wrapped with np.frombuffer)."""
    raw = memoryview(Path(path).read_bytes())
    net_name = ""
    layers: list[CaffeLayerBlobs] = []
    for fnum, wt, val in iter_fields(raw):
        if fnum == 1 and wt == 2:
            net_name = bytes(val).decode("utf-8", "replace")
        elif fnum == 100 and wt == 2:  # modern LayerParameter
            name = ltype = ""
            blobs: list[np.ndarray] = []
            for f2, w2, v2 in iter_fields(val):
                if f2 == 1 and w2 == 2:
                    name = bytes(v2).decode("utf-8", "replace")
                elif f2 == 2 and w2 == 2:
                    ltype = bytes(v2).decode("utf-8", "replace")
                elif f2 == 7 and w2 == 2:
                    blobs.append(_decode_blob(v2))
            layers.append(CaffeLayerBlobs(name=name, type=ltype, blobs=blobs))
        elif fnum == 2 and wt == 2:  # legacy V1LayerParameter
            name, ltype = "", ""
            blobs = []
            for f2, w2, v2 in iter_fields(val):
                if f2 == 4 and w2 == 2:
                    name = bytes(v2).decode("utf-8", "replace")
                elif f2 == 5 and w2 == 0:
                    ltype = _V1_TYPES.get(v2, f"V1_{v2}")
                elif f2 == 6 and w2 == 2:
                    blobs.append(_decode_blob(v2))
            layers.append(CaffeLayerBlobs(name=name, type=ltype, blobs=blobs))
    return net_name, layers


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _encode_blob_chunks(arr: np.ndarray) -> list:
    """BlobProto as a chunk list: the raw float buffer is appended as a
    zero-copy memoryview over the (contiguous f4) array, never copied into
    a growing bytearray or duplicated via tobytes() (a 553 MB VGG-16
    export previously spent ~45 s on those copies; now it is IO-bound)."""
    head = bytearray()
    shape = bytearray()
    dims = bytearray()
    for d in arr.shape:
        _write_varint(dims, int(d))
    _put_bytes(shape, 1, bytes(dims))        # BlobShape.dim (packed)
    _put_bytes(head, 7, bytes(shape))        # BlobProto.shape
    data = memoryview(np.ascontiguousarray(arr, "<f4")).cast("B")
    _tag(head, 5, 2)                         # BlobProto.data (packed float)
    _write_varint(head, len(data))
    return [bytes(head), data]


def save_caffemodel(path: str | Path, net_name: str,
                    layers: list[CaffeLayerBlobs]) -> None:
    chunks: list[bytes] = []
    head = bytearray()
    _put_string(head, 1, net_name)
    chunks.append(bytes(head))
    for l in layers:
        lp_chunks: list[bytes] = []
        hb = bytearray()
        _put_string(hb, 1, l.name)
        _put_string(hb, 2, l.type)
        lp_chunks.append(bytes(hb))
        for b in l.blobs:
            bc = _encode_blob_chunks(np.asarray(b))
            tag = bytearray()
            _tag(tag, 7, 2)                  # NetParameter.layer.blobs
            _write_varint(tag, sum(len(c) for c in bc))
            lp_chunks.append(bytes(tag))
            lp_chunks.extend(bc)
        tag = bytearray()
        _tag(tag, 100, 2)                    # NetParameter.layer
        _write_varint(tag, sum(len(c) for c in lp_chunks))
        chunks.append(bytes(tag))
        chunks.extend(lp_chunks)
    with open(Path(path), "wb") as f:
        for c in chunks:
            f.write(c)
