"""From-scratch read/write support for Caffe's LMDB datasets (port of
channel_pruning_tpu/data/lmdb.py: the reader, writer and Datum codec are
numpy-only copies; `lmdb_batches` runs encoded Datums through the port's
`data/pipeline.preprocess`).

The reference feeds ImageNet through Caffe's `Data` layer with an LMDB
backend (lib/net.py:813-822, cfgs.py:14-15). The project does not depend
on liblmdb: this module implements the on-disk LMDB format directly
(little-endian 64-bit, the format every stock `data.mdb` uses):

* `LMDBReader` — zero-copy mmap cursor over all key/value records
  (meta-page selection by txnid, B+tree walk, overflow-page reassembly).
* `write_lmdb` — minimal single-transaction writer (sorted keys, bulk-load
  style bottom-up B+tree), used for tests and for building calibration sets.
* `Datum` encode/decode — Caffe's sample protobuf (channels/height/width/
  data/label/float_data/encoded), on top of io/caffemodel's wire codec.
* `lmdb_batches` — the Data-layer equivalent: yields (images, labels)
  batches with the Caffe BGR/mean/crop transform applied by the caller's
  pipeline.

Format reference: LMDB 0.9 (mdb.c `MDB_page`/`MDB_node`/`MDB_meta`).
Validated by round-tripping through the writer and by struct-level
assertions (magic, version, page linkage), without liblmdb to
cross-check, so the writer intentionally emits the most conservative
layout (fresh file, sequential pages, both metas).
"""
from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from channel_pruning_tpu_torch.io.caffemodel import (
    _put_bytes, _tag, _write_varint, iter_fields)

MDB_MAGIC = 0xBEEFC0DE
MDB_VERSION = 1
PAGESIZE = 4096
PAGEHDRSZ = 16
NODESZ = 8                       # offsetof(MDB_node, mn_data)
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
P_LEAF2 = 0x20
F_BIGDATA = 0x01
P_INVALID = 0xFFFFFFFFFFFFFFFF

_META = struct.Struct("<II Q Q")              # magic, version, address, mapsize
_DB = struct.Struct("<IHH QQQQQ")             # pad, flags, depth, branch/leaf/
                                              # overflow pages, entries, root
_PGHDR = struct.Struct("<Q HH HH")            # pgno, pad, flags, lower, upper


def _even(n: int) -> int:
    return (n + 1) & ~1


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class LMDBReader:
    """Sequential cursor over an LMDB main database (read-only mmap)."""

    def __init__(self, path: str | Path):
        path = Path(path)
        if path.is_dir():
            path = path / "data.mdb"
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._buf = memoryview(self._mm)
        meta = self._pick_meta()
        (self.psize, _mflags, self.depth, _bp, _lp, _op,
         self.entries, self.root) = meta

    def _meta_at(self, off: int):
        magic, version, _addr, _mapsize = _META.unpack_from(self._buf, off)
        if magic != MDB_MAGIC:
            raise ValueError(f"not an LMDB file (magic {magic:#x})")
        if version != MDB_VERSION:
            raise ValueError(f"unsupported LMDB format version {version}")
        off += _META.size
        free_db = _DB.unpack_from(self._buf, off)
        main_db = _DB.unpack_from(self._buf, off + _DB.size)
        _last_pg, txnid = struct.unpack_from("<QQ", self._buf,
                                             off + 2 * _DB.size)
        psize = free_db[0]                     # mm_psize aliases free-DB pad
        return txnid, (psize, main_db[1], main_db[2], main_db[3], main_db[4],
                       main_db[5], main_db[6], main_db[7])

    def _pick_meta(self):
        # page size is unknown until a meta is parsed; meta 0 is at page 0,
        # meta 1 at one page later — probe with the psize meta 0 declares
        t0, m0 = self._meta_at(PAGEHDRSZ)
        t1, m1 = self._meta_at(m0[0] + PAGEHDRSZ)
        return m1 if t1 > t0 else m0

    def _page(self, pgno: int):
        off = pgno * self.psize
        _pg, _pad, flags, lower, upper = _PGHDR.unpack_from(self._buf, off)
        return off, flags, lower, upper

    def _node(self, page_off: int, ptr_off: int):
        (noff,) = struct.unpack_from("<H", self._buf, page_off + ptr_off)
        base = page_off + noff
        lo, hi, nflags, ksize = struct.unpack_from("<HHHH", self._buf, base)
        key = bytes(self._buf[base + NODESZ:base + NODESZ + ksize])
        return base, lo, hi, nflags, ksize, key

    def _leaf_value(self, base: int, lo: int, hi: int, nflags: int,
                    ksize: int) -> bytes:
        dsize = lo | (hi << 16)
        dstart = base + NODESZ + ksize
        if nflags & F_BIGDATA:
            (ovpg,) = struct.unpack_from("<Q", self._buf, dstart)
            ooff = ovpg * self.psize
            oflags = _PGHDR.unpack_from(self._buf, ooff)[2]
            if not oflags & P_OVERFLOW:
                raise ValueError(f"page {ovpg} is not an overflow page")
            # payload runs contiguously across the overflow chain
            return bytes(self._buf[ooff + PAGEHDRSZ:
                                   ooff + PAGEHDRSZ + dsize])
        return bytes(self._buf[dstart:dstart + dsize])

    def items(self) -> Iterator[tuple[bytes, bytes]]:
        """All (key, value) pairs in key order."""
        if self.root == P_INVALID:
            return
        yield from self._walk(self.root)

    def leaf_refs(self) -> list[tuple[int, int, int, int, int]]:
        """Stable references to every record, in key order. Each ref can be
        read in any order via `value_at` while the reader stays open —
        the random-access path that lets a Data-layer source shuffle
        (the reference shuffles at the LMDB cursor, lib/net.py:813-822)."""
        refs: list[tuple[int, int, int, int, int]] = []
        if self.root == P_INVALID:
            return refs

        def walk(pgno: int) -> None:
            page_off, flags, lower, _upper = self._page(pgno)
            n = (lower - PAGEHDRSZ) // 2
            if flags & P_LEAF2:
                raise NotImplementedError("LEAF2 (dupfixed) pages")
            for i in range(n):
                base, lo, hi, nflags, ksize, _key = self._node(
                    page_off, PAGEHDRSZ + 2 * i)
                if flags & P_BRANCH:
                    walk(lo | (hi << 16) | (nflags << 32))
                else:
                    refs.append((base, lo, hi, nflags, ksize))

        walk(self.root)
        return refs

    def value_at(self, ref: tuple[int, int, int, int, int]) -> bytes:
        return self._leaf_value(*ref)

    def _walk(self, pgno: int) -> Iterator[tuple[bytes, bytes]]:
        page_off, flags, lower, upper = self._page(pgno)
        n = (lower - PAGEHDRSZ) // 2
        if flags & P_LEAF2:
            raise NotImplementedError("LEAF2 (dupfixed) pages")
        for i in range(n):
            base, lo, hi, nflags, ksize, key = self._node(
                page_off, PAGEHDRSZ + 2 * i)
            if flags & P_BRANCH:
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._walk(child)
            else:
                yield key, self._leaf_value(base, lo, hi, nflags, ksize)

    def __len__(self) -> int:
        return int(self.entries)

    def close(self) -> None:
        self._buf.release()
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# writer (bulk load, sorted keys, one transaction)
# ---------------------------------------------------------------------------

def write_lmdb(path: str | Path, items: Sequence[tuple[bytes, bytes]],
               psize: int = PAGESIZE) -> Path:
    """Create `<path>/data.mdb` holding `items` (sorted by key on write).
    Big values go to overflow pages exactly like liblmdb's put."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    items = sorted(items, key=lambda kv: kv[0])
    nodemax = ((psize - PAGEHDRSZ) // 2) & ~1

    pages: list[bytes] = [b"", b""]            # metas filled last (pgno 0, 1)
    counts = {"branch": 0, "leaf": 0, "overflow": 0}

    def emit(raw: bytes) -> int:
        pages.append(raw)
        return len(pages) - 1

    def page_bytes(pgno: int, flags: int, nodes: list[bytes],
                   n_over: int = 0) -> bytes:
        if flags & P_OVERFLOW:
            hdr = struct.pack("<Q HH I", pgno, 0, flags, n_over)
            return hdr  # caller appends payload
        lower = PAGEHDRSZ + 2 * len(nodes)
        upper = psize - sum(_even(len(nd)) for nd in nodes)
        hdr = _PGHDR.pack(pgno, 0, flags, lower, upper)
        ptrs, blob, off = [], b"", upper
        for nd in nodes:
            ptrs.append(struct.pack("<H", off))
            blob += nd + b"\x00" * (_even(len(nd)) - len(nd))
            off += _even(len(nd))
        body = hdr + b"".join(ptrs)
        return body + b"\x00" * (upper - len(body)) + blob

    # ---- leaves (and overflow chains) -------------------------------------
    def leaf_node(key: bytes, val: bytes) -> bytes:
        if NODESZ + len(key) + len(val) > nodemax:
            n_over = -(-(PAGEHDRSZ + len(val)) // psize)
            opg = len(pages)
            raw = page_bytes(opg, P_OVERFLOW, [], n_over) + val
            raw += b"\x00" * (n_over * psize - len(raw))
            for i in range(n_over):
                emit(raw[i * psize:(i + 1) * psize])
            counts["overflow"] += n_over
            head = struct.pack("<HHHH", len(val) & 0xFFFF, len(val) >> 16,
                               F_BIGDATA, len(key))
            return head + key + struct.pack("<Q", opg)
        head = struct.pack("<HHHH", len(val) & 0xFFFF, len(val) >> 16,
                           0, len(key))
        return head + key + val

    level: list[tuple[bytes, int]] = []        # (first key, pgno)
    cur_nodes: list[bytes] = []
    cur_first: bytes | None = None
    cur_size = PAGEHDRSZ

    def flush_leaf():
        nonlocal cur_nodes, cur_first, cur_size
        if not cur_nodes:
            return
        pg = len(pages)
        pages.append(b"")                       # reserve pgno before overflow?
        pages[pg] = page_bytes(pg, P_LEAF, cur_nodes)
        counts["leaf"] += 1
        level.append((cur_first, pg))
        cur_nodes, cur_first, cur_size = [], None, PAGEHDRSZ

    for key, val in items:
        nd = leaf_node(key, val)
        need = _even(len(nd)) + 2
        if cur_nodes and cur_size + need > psize:
            flush_leaf()
        if not cur_nodes:
            cur_first = key
        cur_nodes.append(nd)
        cur_size += need
    flush_leaf()

    # ---- branches bottom-up ------------------------------------------------
    depth = 1
    while len(level) > 1:
        depth += 1
        nxt: list[tuple[bytes, int]] = []
        bnodes: list[bytes] = []
        bfirst: bytes | None = None
        bsize = PAGEHDRSZ

        def bnode(key: bytes, child: int, first: bool) -> bytes:
            k = b"" if first else key
            return struct.pack("<HHHH", child & 0xFFFF,
                               (child >> 16) & 0xFFFF,
                               (child >> 32) & 0xFFFF, len(k)) + k

        def flush_branch():
            nonlocal bnodes, bfirst, bsize
            if not bnodes:
                return
            pg = emit(b"")
            pages[pg] = page_bytes(pg, P_BRANCH, bnodes)
            counts["branch"] += 1
            nxt.append((bfirst, pg))
            bnodes, bfirst, bsize = [], None, PAGEHDRSZ

        for key, child in level:
            nd = bnode(key, child, first=not bnodes)
            need = _even(len(nd)) + 2
            if bnodes and bsize + need > psize:
                flush_branch()
                nd = bnode(key, child, first=True)
                need = _even(len(nd)) + 2
            if not bnodes:
                bfirst = key
            bnodes.append(nd)
            bsize += need
        flush_branch()
        level = nxt

    root = level[0][1] if level else P_INVALID
    if not items:
        depth = 0
    last_pg = len(pages) - 1
    mapsize = max(len(pages) * psize, 1 << 20)

    def meta_page(pgno: int, txnid: int) -> bytes:
        hdr = _PGHDR.pack(pgno, 0, P_META, 0, 0)
        meta = _META.pack(MDB_MAGIC, MDB_VERSION, 0, mapsize)
        free_db = _DB.pack(psize, 0, 0, 0, 0, 0, 0, P_INVALID)
        main_db = _DB.pack(0, 0, depth, counts["branch"], counts["leaf"],
                           counts["overflow"], len(items), root)
        tail = struct.pack("<QQ", last_pg, txnid)
        raw = hdr + meta + free_db + main_db + tail
        return raw + b"\x00" * (psize - len(raw))

    pages[0] = meta_page(0, 0)
    pages[1] = meta_page(1, 1)

    out = path / "data.mdb"
    with open(out, "wb") as f:
        for pgno, raw in enumerate(pages):
            if len(raw) != psize:
                raise AssertionError(f"page {pgno} is {len(raw)} bytes")
            f.write(raw)
    return out


# ---------------------------------------------------------------------------
# Caffe Datum codec (caffe.proto `message Datum`)
# ---------------------------------------------------------------------------

@dataclass
class Datum:
    channels: int = 0
    height: int = 0
    width: int = 0
    data: bytes = b""
    label: int = -1
    float_data: list[float] = field(default_factory=list)
    encoded: bool = False

    def to_array(self) -> np.ndarray:
        """(C, H, W) float32 in Caffe's BGR channel order."""
        if self.encoded:
            import io as _io

            from PIL import Image
            img = Image.open(_io.BytesIO(self.data)).convert("RGB")
            arr = np.asarray(img, np.float32).transpose(2, 0, 1)[::-1]
            return np.ascontiguousarray(arr)
        if self.float_data:
            return np.asarray(self.float_data, np.float32).reshape(
                self.channels, self.height, self.width)
        return np.frombuffer(self.data, np.uint8).astype(np.float32).reshape(
            self.channels, self.height, self.width)


def encode_datum(d: Datum) -> bytes:
    out = bytearray()
    for fnum, val in ((1, d.channels), (2, d.height), (3, d.width)):
        _tag(out, fnum, 0)
        _write_varint(out, val)
    if d.data:
        _put_bytes(out, 4, d.data)
    if d.label >= 0:
        _tag(out, 5, 0)
        _write_varint(out, d.label)
    if d.float_data:
        packed = np.asarray(d.float_data, np.float32).tobytes()
        _put_bytes(out, 6, packed)
    if d.encoded:
        _tag(out, 7, 0)
        _write_varint(out, 1)
    return bytes(out)


def decode_datum(buf: bytes) -> Datum:
    d = Datum()
    for fnum, wt, val in iter_fields(memoryview(buf)):
        if fnum == 1:
            d.channels = int(val)
        elif fnum == 2:
            d.height = int(val)
        elif fnum == 3:
            d.width = int(val)
        elif fnum == 4:
            d.data = bytes(val)
        elif fnum == 5:
            d.label = int(val) - (1 << 64 if val >= 1 << 63 else 0)
        elif fnum == 6:
            if wt == 2:  # packed
                d.float_data = np.frombuffer(bytes(val), "<f4").tolist()
            else:
                d.float_data.append(struct.unpack("<f", struct.pack("<I", val))[0])
        elif fnum == 7:
            d.encoded = bool(val)
    return d


# ---------------------------------------------------------------------------
# Data-layer source
# ---------------------------------------------------------------------------

def lmdb_batches(path: str | Path, batch: int, *, new_dim: int = 256,
                 crop: int = 224, mean: np.ndarray | None = None,
                 loop: bool = False, shuffle: bool = False, seed: int = 0,
                 random_crop: bool = False,
                 ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Caffe `Data`-layer equivalent over an LMDB of Datum records: yields
    ((batch, 3, crop, crop) float32 BGR mean-subtracted, (batch,) labels).

    Raw (pre-sized) Datums get the Data layer's crop + mean subtract; with
    `random_crop` the TRAIN-phase transform (random crop offset + horizontal
    mirror, lib/net.py:813-822 transform_param), else the TEST-phase center
    crop. `shuffle` re-orders records per epoch with a seeded rng — without
    it a class-sorted LMDB would feed a biased calibration stream. `encoded`
    JPEG/PNG Datums go through the same bicubic-256/crop pipeline as the
    ImageData source. With loop=True, partial batches carry across epoch
    boundaries so tail records are never dropped."""
    import torch

    from channel_pruning_tpu_torch.data.pipeline import BGR_MEAN, preprocess

    mean_px = (np.asarray(mean, np.float32) if mean is not None
               else BGR_MEAN)
    if mean_px.ndim == 1:
        mean_px = mean_px[:, None, None]
    rng = np.random.default_rng(seed)

    def transform(d: Datum) -> np.ndarray:
        if d.encoded:
            rgb_hwc = d.to_array()[::-1].transpose(1, 2, 0)  # BGR CHW -> RGB HWC
            # one numpy draw per record seeds the crop's generator, as the
            # JAX package seeds its key: the mirror draws stay in step
            gen = (torch.Generator().manual_seed(int(rng.integers(2 ** 31)))
                   if random_crop else None)
            out = preprocess(rgb_hwc, new_dim=new_dim, crop=crop,
                             random_crop=random_crop, generator=gen,
                             mean=np.zeros(3, np.float32)).numpy()
            sub = mean_px[:, :crop, :crop] if mean_px.shape[1] > 1 else mean_px
            out = out - sub
            if random_crop and rng.random() < 0.5:
                out = out[:, :, ::-1]                        # mirror
            return out
        arr = d.to_array()                                   # BGR CHW
        h, w = arr.shape[1], arr.shape[2]
        if h < crop or w < crop:
            raise ValueError(f"datum {arr.shape} smaller than crop {crop}")
        if random_crop:
            y0 = int(rng.integers(0, h - crop + 1))
            x0 = int(rng.integers(0, w - crop + 1))
        else:
            y0, x0 = (h - crop) // 2, (w - crop) // 2
        sub = mean_px[:, :crop, :crop] if mean_px.shape[1] > 1 else mean_px
        out = arr[:, y0:y0 + crop, x0:x0 + crop] - sub
        if random_crop and rng.random() < 0.5:
            out = out[:, :, ::-1]
        return out

    with LMDBReader(path) as rd:
        if len(rd) == 0:
            raise ValueError(f"LMDB at {path} holds no records")
        # shuffle needs random access (leaf refs materialised once); the
        # sequential path streams the B-tree cursor walk instead — an
        # ImageNet-scale eval should not allocate 1.3M ref tuples up front
        # or lose page locality just to read in order
        refs = rd.leaf_refs() if shuffle else None
        imgs, labels = [], []
        while True:
            if shuffle:
                order = rng.permutation(len(refs))
                raw_iter = (rd.value_at(refs[i]) for i in order)
            else:
                raw_iter = (v for _, v in rd.items())
            for raw in raw_iter:
                d = decode_datum(raw)
                imgs.append(transform(d))
                labels.append(d.label)
                if len(imgs) == batch:
                    yield (np.stack(imgs).astype(np.float32),
                           np.asarray(labels, np.int32))
                    imgs, labels = [], []
            if not loop:
                if imgs:
                    yield (np.stack(imgs).astype(np.float32),
                           np.asarray(labels, np.int32))
                return
