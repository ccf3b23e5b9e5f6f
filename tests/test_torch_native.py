"""The port's native host codecs, built with g++ at first use: the
caffemodel wire indexer (csrc/caffemodel.cpp via io/native_caffemodel) held
to the Python walk on every caffemodel written here, its counted fallback
and its refusal to fall back on a failed build; and the C++/OpenMP
preprocess (csrc/preprocess.cpp) held to the port's data.pipeline.preprocess
at the tolerances of tests/test_native.py."""
import numpy as np
import pytest

from channel_pruning_tpu_torch.data import native_preprocess as npp
from channel_pruning_tpu_torch.data.pipeline import preprocess
from channel_pruning_tpu_torch.io import caffe as cio
from channel_pruning_tpu_torch.io import caffemodel as cm
from channel_pruning_tpu_torch.io import native_caffemodel as ncm
from channel_pruning_tpu_torch.models.resnet import build_tiny_resnet
from channel_pruning_tpu_torch.models.vgg import build_tiny_vgg
from channel_pruning_tpu_torch.models.xception import build_tiny_xception
from channel_pruning_tpu_torch.utils import native
from torch_cpu import one_thread  # noqa: F401


def _assert_same(a, b):
    """Equal net names and records: names, types, shapes, dtypes, bytes."""
    (an, al), (bn, bl) = a, b
    assert an == bn
    assert len(al) == len(bl)
    for x, y in zip(al, bl):
        assert (x.name, x.type, len(x.blobs)) == (y.name, y.type, len(y.blobs))
        for u, v in zip(x.blobs, y.blobs):
            assert u.shape == v.shape and u.dtype == v.dtype
            assert u.tobytes() == v.tobytes(), x.name


def _both(path):
    before = cm.native_fallbacks
    got = cm.load_caffemodel(path)
    return got, cm.load_caffemodel_python(path), cm.native_fallbacks - before


BUILDERS = {"tiny_vgg": build_tiny_vgg, "tiny_resnet": build_tiny_resnet,
            "tiny_xception": build_tiny_xception}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_native_equals_python_walk_on_exported_models(tmp_path, name):
    """BN blobs (mean, var, factor) included: tiny_xception has them."""
    g, params = BUILDERS[name](batch=2)
    cio.export_model(g, params, tmp_path / "m.prototxt",
                     tmp_path / "m.caffemodel")
    got, want, fell_back = _both(tmp_path / "m.caffemodel")
    assert fell_back == 0                  # the native path was taken
    _assert_same(got, want)
    assert got[0] == g.name and sum(len(l.blobs) for l in got[1]) > 0


def _legacy_v1_file(path):
    """tests/test_native_caffemodel.py's released-2015-era shape: the V1
    `layers` field (2), legacy num/c/h/w dims, packed double data and a
    double_diff that must be skipped."""
    out = bytearray()
    cm._put_string(out, 1, "legacy_net")
    layer = bytearray()
    cm._put_string(layer, 4, "conv1")
    cm._tag(layer, 5, 0)
    cm._write_varint(layer, 4)                 # V1 enum: Convolution
    blob = bytearray()
    for f, v in ((1, 2), (2, 3), (3, 1), (4, 1)):
        cm._tag(blob, f, 0)
        cm._write_varint(blob, v)
    data = np.arange(6, dtype="<f8")
    cm._tag(blob, 8, 2)
    cm._write_varint(blob, data.nbytes)
    blob += data.tobytes()
    diff = np.full(6, 99.0, dtype="<f8")
    cm._tag(blob, 9, 2)
    cm._write_varint(blob, diff.nbytes)
    blob += diff.tobytes()
    cm._put_bytes(layer, 6, bytes(blob))
    cm._put_bytes(out, 2, bytes(layer))
    relu = bytearray()
    cm._put_string(relu, 4, "relu1")
    cm._tag(relu, 5, 0)
    cm._write_varint(relu, 18)                 # V1 enum: ReLU
    cm._put_bytes(out, 2, bytes(relu))
    path.write_bytes(bytes(out))


def _legacy_shape_file(path):
    """tests/test_caffe_io.py::test_caffemodel_wire_blob_legacy_dims: a
    modern layer whose blob carries only legacy num/channels/height/width."""
    data = np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2)
    blob = bytearray()
    for fnum, v in ((1, 2), (2, 3), (3, 2), (4, 2)):
        cm._tag(blob, fnum, 0)
        cm._write_varint(blob, v)
    cm._put_bytes(blob, 5, data.tobytes())
    lp = bytearray()
    cm._put_string(lp, 1, "conv")
    cm._put_string(lp, 2, "Convolution")
    cm._put_bytes(lp, 7, bytes(blob))
    out = bytearray()
    cm._put_string(out, 1, "legacy_net")
    cm._put_bytes(out, 100, bytes(lp))
    path.write_bytes(bytes(out))
    return data


def test_native_equals_python_walk_on_v1_layers(tmp_path):
    p = tmp_path / "v1.caffemodel"
    _legacy_v1_file(p)
    got, want, fell_back = _both(p)
    assert fell_back == 0
    _assert_same(got, want)
    assert [(l.name, l.type) for l in got[1]] == [("conv1", "Convolution"),
                                                  ("relu1", "ReLU")]
    np.testing.assert_array_equal(got[1][0].blobs[0],
                                  np.arange(6, dtype=np.float32).reshape(2, 3, 1, 1))


def test_native_equals_python_walk_on_legacy_shapes(tmp_path):
    p = tmp_path / "legacy.caffemodel"
    data = _legacy_shape_file(p)
    got, want, fell_back = _both(p)
    assert fell_back == 0
    _assert_same(got, want)
    np.testing.assert_array_equal(got[1][0].blobs[0], data)


def test_truncated_file_raises_in_both_paths(tmp_path):
    g, params = build_tiny_vgg(batch=2)
    cio.export_model(g, params, tmp_path / "m.prototxt",
                     tmp_path / "m.caffemodel")
    raw = (tmp_path / "m.caffemodel").read_bytes()
    for cut in (len(raw) - 10, len(raw) // 2):
        p = tmp_path / f"cut{cut}.caffemodel"
        p.write_bytes(raw[:cut])
        with pytest.raises(ValueError):
            cm.load_caffemodel(p)
        with pytest.raises(ValueError):
            cm.load_caffemodel_python(p)


def test_unsupported_construct_takes_the_counted_fallback(tmp_path):
    """An unpacked float (BlobProto.data with wire type 5), which the
    indexer does not support: it returns -1, the Python walk reads the
    file, and the fallback is counted."""
    blob = bytearray()
    cm._tag(blob, 5, 5)
    blob += np.float32(2.5).tobytes()
    lp = bytearray()
    cm._put_string(lp, 1, "scale")
    cm._put_string(lp, 2, "Scale")
    cm._put_bytes(lp, 7, bytes(blob))
    out = bytearray()
    cm._put_string(out, 1, "net")
    cm._put_bytes(out, 100, bytes(lp))
    p = tmp_path / "unpacked.caffemodel"
    p.write_bytes(bytes(out))
    assert ncm.load_caffemodel_native(p) is None
    got, want, fell_back = _both(p)
    assert fell_back == 1
    _assert_same(got, want)
    np.testing.assert_array_equal(got[1][0].blobs[0], [2.5])


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(bad)
    assert not list((tmp_path / "_build").glob("*.so"))


def test_failed_build_does_not_fall_back(tmp_path, monkeypatch):
    """A build or load failure of the indexer raises from load_caffemodel:
    only the indexer's own -1 may send a load to the Python walk."""
    p = tmp_path / "legacy.caffemodel"
    _legacy_shape_file(p)

    def fail(source):
        raise RuntimeError("g++ failed (1): simulated")

    monkeypatch.setattr(ncm, "_lib", None)
    monkeypatch.setattr(native, "build", fail)
    before = cm.native_fallbacks
    with pytest.raises(RuntimeError, match="simulated"):
        cm.load_caffemodel(p)
    assert cm.native_fallbacks == before


def test_library_name_carries_source_and_target():
    a = native.library_path(ncm.SOURCE)
    b = native.library_path(npp.SOURCE)
    assert a.parent == native.BUILD_DIR and a != b
    assert a.name.startswith("libcaffemodel_") and a.suffix == ".so"


def test_native_preprocess_matches_pipeline(rng):
    """tests/test_native.py::test_native_matches_jax_bicubic's bounds
    against the port's preprocess: interior max < 1.5, mean < 0.1 (the
    borders differ by the edge handling)."""
    img = rng.integers(0, 256, (300, 400, 3)).astype(np.uint8)
    got = npp.preprocess_image(img, new_dim=256, crop=224)
    want = preprocess(img, new_dim=256, crop=224).numpy()
    assert got.shape == want.shape == (3, 224, 224)
    diff = np.abs(got[:, 4:-4, 4:-4] - want[:, 4:-4, 4:-4])
    assert diff.max() < 1.5, diff.max()
    assert diff.mean() < 0.1


def test_native_batch_matches_single(rng):
    imgs = rng.integers(0, 256, (8, 260, 320, 3)).astype(np.uint8)
    batch = npp.preprocess_batch(imgs, new_dim=256, crop=224)
    for i in (0, 3, 7):
        np.testing.assert_array_equal(
            batch[i], npp.preprocess_image(imgs[i], new_dim=256, crop=224))
    assert npp.num_threads() >= 1


def test_native_crop_coords_and_tall_images(rng):
    img = rng.integers(0, 256, (256, 300, 3)).astype(np.uint8)
    a = npp.preprocess_image(img, new_dim=256, crop=200, crop_yx=(0, 0))
    b = npp.preprocess_image(img, new_dim=256, crop=200, crop_yx=(10, 30))
    assert not np.array_equal(a, b)
    tall = rng.integers(0, 256, (500, 250, 3)).astype(np.uint8)
    out = npp.preprocess_image(tall, new_dim=256, crop=224)
    want = preprocess(tall, new_dim=256, crop=224).numpy()
    assert out.shape == (3, 224, 224) and np.isfinite(out).all()
    diff = np.abs(out[:, 4:-4, 4:-4] - want[:, 4:-4, 4:-4])
    assert diff.max() < 1.5 and diff.mean() < 0.1
