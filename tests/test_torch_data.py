"""The port's input pipeline (data/pipeline.py, data/lmdb.py) against the
JAX package's on the same images, files and seeds, on the CPU.

`preprocess` agrees to 1e-3 on the 0-255 scale (the resize is the same
weight matrices, summed in another order); everything else is equal:
the binaryproto mean, center-crop imagefolder batches to 1e-3, the
memory_batches order, and LMDB batches of raw Datums including their
random crops and mirrors (both packages draw those from numpy). Random
crops of decoded images come from a torch.Generator in the port and from
jax.random in the JAX package, so only their shape and their spread are
compared."""
import io

import jax.numpy as jnp
import numpy as np
import pytest

from channel_pruning_tpu.data import lmdb as jax_lmdb
from channel_pruning_tpu.data import pipeline as jax_dp
from channel_pruning_tpu.io.caffemodel import _put_bytes, _tag, _write_varint
from channel_pruning_tpu_torch.data import lmdb
from channel_pruning_tpu_torch.data import pipeline as dp
from torch_cpu import one_thread  # noqa: F401

Image = pytest.importorskip("PIL.Image")


@pytest.mark.parametrize("hwc,new_dim,crop", [
    ((40, 52, 3), 64, 56),       # upsample, landscape
    ((52, 40, 3), 64, 56),       # upsample, portrait
    ((300, 200, 3), 36, 32),     # downsample, portrait
    ((200, 300, 3), 36, 32),     # downsample, landscape
    ((30, 30, 3), 30, 24),       # no resize
])
def test_preprocess_matches_jax(hwc, new_dim, crop):
    img = np.random.default_rng(0).integers(0, 256, hwc).astype(np.uint8)
    mean = np.random.default_rng(1).uniform(90, 130, (crop, crop, 3)).astype(np.float32)
    for m in (None, mean):
        got = dp.preprocess(img, new_dim=new_dim, crop=crop, mean=m).numpy()
        want = np.asarray(jax_dp.preprocess(
            jnp.asarray(img), new_dim=new_dim, crop=crop,
            mean=None if m is None else jnp.asarray(m)))
        assert got.shape == want.shape == (3, crop, crop)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_resize_is_not_torch_bicubic():
    """Keys a = -0.5 with renormalised edges: the ramp 0..7 upsampled to 16
    starts at -0.0882, 0.1679 (jax.image), not torch's -0.1055, 0.1914."""
    import jax

    ramp = np.arange(8, dtype=np.float32)
    got = dp.resize_matrix(8, 16) @ ramp
    want = np.asarray(jax.image.resize(jnp.asarray(ramp), (16,), "bicubic",
                                       antialias=False))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[:2], [-0.0882353, 0.1678832], atol=1e-6)


def test_random_crop_draws_from_the_generator():
    import torch

    img = np.random.default_rng(2).integers(0, 256, (40, 60, 3)).astype(np.uint8)
    outs = {dp.preprocess(img, new_dim=40, crop=32, random_crop=True,
                          generator=torch.Generator().manual_seed(s)).numpy().tobytes()
            for s in range(6)}
    assert len(outs) > 1
    a = dp.preprocess(img, new_dim=40, crop=32, random_crop=True,
                      generator=torch.Generator().manual_seed(3))
    b = dp.preprocess(img, new_dim=40, crop=32, random_crop=True,
                      generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


def test_binaryproto_mean_equals_jax(tmp_path):
    """A BlobProto mean (num=1, 3 x 10 x 12) through both decoders, whole
    and center-cropped, and as a pixel mean."""
    arr = np.random.default_rng(3).uniform(0, 255, (1, 3, 10, 12)).astype(np.float32)
    out = bytearray()
    for fnum, v in zip((1, 2, 3, 4), arr.shape):
        _tag(out, fnum, 0)
        _write_varint(out, v)
    _put_bytes(out, 5, arr.tobytes())
    path = tmp_path / "mean.binaryproto"
    path.write_bytes(bytes(out))
    for crop in (None, 8):
        got = dp.load_binaryproto_mean(path, crop=crop)
        want = jax_dp.load_binaryproto_mean(path, crop=crop)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(dp.as_pixel_mean(got), jax_dp.as_pixel_mean(want))
    np.save(tmp_path / "m.npy", arr[0])
    np.testing.assert_array_equal(dp.load_mean_file(tmp_path / "m.npy"),
                                  jax_dp.load_mean_file(tmp_path / "m.npy"))


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for ci, cls in enumerate(("cat", "dog", "eel")):
        (root / cls).mkdir()
        for i in range(3):
            arr = rng.integers(0, 256, (40 + 10 * ci, 52, 3)).astype(np.uint8)
            Image.fromarray(arr).save(root / cls / f"{i}.png")
    return root


def test_imagefolder_batches_equal_jax(image_dir):
    kw = dict(batch=2, new_dim=36, crop=32, shuffle=True, seed=4)
    got = list(dp.imagefolder_batches(image_dir, **kw))
    want = list(jax_dp.imagefolder_batches(image_dir, **kw))
    assert len(got) == len(want) == 4
    for (x, y), (xj, yj) in zip(got, want):
        np.testing.assert_array_equal(y, yj)
        np.testing.assert_allclose(x, xj, rtol=0, atol=1e-3)
    X, y = dp.preload_imagefolder(image_dir, new_dim=36, crop=32)
    Xj, yj = jax_dp.preload_imagefolder(image_dir, new_dim=36, crop=32)
    np.testing.assert_array_equal(y, yj)
    np.testing.assert_allclose(X, Xj, rtol=0, atol=1e-3)
    crops = list(dp.imagefolder_batches(image_dir, batch=2, new_dim=40, crop=32,
                                        random_crop=True, seed=1))
    assert crops[0][0].shape == (2, 3, 32, 32)


def test_memory_and_calibration_batches_equal_jax():
    X = np.arange(11 * 2, dtype=np.float32).reshape(11, 2)
    y = np.arange(11, dtype=np.int32)
    for kw in ({}, {"shuffle": True, "seed": 5}):
        a = [b[1].tolist() for b in dp.memory_batches(X, y, 3, **kw)]
        b = [b[1].tolist() for b in jax_dp.memory_batches(X, y, 3, **kw)]
        assert a == b and len(a) == 3
    src = dp.memory_batches(X, y, 3, shuffle=True, seed=2, loop=True)
    src_j = jax_dp.memory_batches(X, y, 3, shuffle=True, seed=2, loop=True)
    got = dp.calibration_batches(src, 5, 3, image=1)
    want = jax_dp.calibration_batches(src_j, 5, 3, image=1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _raw_db(path, n, hw, module):
    rng = np.random.default_rng(6)
    items = []
    for i in range(n):
        arr = rng.integers(0, 256, (3, hw, hw), np.uint8)
        d = module.Datum(channels=3, height=hw, width=hw, data=arr.tobytes(),
                         label=i % 7)
        items.append((f"{i:06d}".encode(), module.encode_datum(d)))
    return module.write_lmdb(path, items)


def test_lmdb_writer_and_codec_equal_jax(tmp_path):
    a = _raw_db(tmp_path / "a", 300, 12, lmdb)
    b = _raw_db(tmp_path / "b", 300, 12, jax_lmdb)
    assert a.read_bytes() == b.read_bytes()
    d = lmdb.Datum(channels=1, height=1, width=2, float_data=[0.5, -2.0], label=3)
    assert lmdb.encode_datum(d) == jax_lmdb.encode_datum(
        jax_lmdb.Datum(channels=1, height=1, width=2, float_data=[0.5, -2.0],
                       label=3))
    assert lmdb.decode_datum(lmdb.encode_datum(d)) == d
    with lmdb.LMDBReader(a) as rd:
        assert len(rd) == 300 and rd.depth >= 2


@pytest.mark.parametrize("kw", [
    dict(crop=8),
    dict(crop=8, shuffle=True, seed=3),
    dict(crop=8, shuffle=True, seed=3, random_crop=True, loop=True),
    dict(crop=10, mean=np.full((3, 12, 12), 100.0, np.float32)),
])
def test_lmdb_batches_of_raw_datums_equal_jax(tmp_path, kw):
    """Center and random crops with mirrors: the same numpy draws on both
    sides, so the batches are equal."""
    db = _raw_db(tmp_path / "db", 50, 12, lmdb)
    got = lmdb.lmdb_batches(db.parent, 16, **kw)
    want = jax_lmdb.lmdb_batches(db.parent, 16, **kw)
    for _ in range(6 if kw.get("loop") else 4):
        (x, y), (xj, yj) = next(got), next(want)
        np.testing.assert_array_equal(y, yj)
        np.testing.assert_array_equal(x, xj)
    if not kw.get("loop"):
        assert next(got, None) is None and next(want, None) is None


def test_lmdb_batches_of_encoded_datums(tmp_path):
    """Encoded PNG Datums go through `preprocess`: center crops equal the
    JAX package's to 1e-3; random crops vary and keep the shape."""
    rng = np.random.default_rng(2)
    items = []
    for i in range(4):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (32, 24, 3), np.uint8)).save(buf, format="PNG")
        items.append((b"%d" % i, lmdb.encode_datum(
            lmdb.Datum(data=buf.getvalue(), label=i, encoded=True))))
    lmdb.write_lmdb(tmp_path / "db", items)
    (x, y), = lmdb.lmdb_batches(tmp_path / "db", 4, new_dim=16, crop=8)
    (xj, yj), = jax_lmdb.lmdb_batches(tmp_path / "db", 4, new_dim=16, crop=8)
    np.testing.assert_array_equal(y, yj)
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-3)
    outs = {next(lmdb.lmdb_batches(tmp_path / "db", 1, new_dim=16, crop=8,
                                   random_crop=True, seed=s))[0].tobytes()
            for s in range(8)}
    assert len(outs) > 1
