"""The port's own copies of the JAX package's numpy modules (graph IR and
rewrites, models, config, FLOPs, the Caffe codec, the solve checkpoint)
against the originals: equal graphs, parameters, counts and config, Caffe
files and checkpoints that each package reads back from the other, and the
port's repair of Select gates whose index list holds only 0s and 1s."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from channel_pruning_tpu.graph import rewrite as jax_rewrite
from channel_pruning_tpu.io import caffe as jax_cio
from channel_pruning_tpu.models import resnet as jax_resnet
from channel_pruning_tpu.models import vgg as jax_vgg
from channel_pruning_tpu.models import zoo as jax_zoo
from channel_pruning_tpu.pipeline import c3 as jax_c3
from channel_pruning_tpu.pipeline.checkpoint import \
    SolveCheckpoint as JaxSolveCheckpoint
from channel_pruning_tpu.utils import config as jax_config
from channel_pruning_tpu.utils import flops as jax_flops
from channel_pruning_tpu_torch.graph import rewrite
from channel_pruning_tpu_torch.graph.ir import LT
from channel_pruning_tpu_torch.io import caffe as cio
from channel_pruning_tpu_torch.io import caffemodel as cm
from channel_pruning_tpu_torch.models import resnet, vgg, zoo
from channel_pruning_tpu_torch.pipeline import c3
from channel_pruning_tpu_torch.pipeline.checkpoint import SolveCheckpoint
from channel_pruning_tpu_torch.utils import config, flops
from torch_cpu import one_thread  # noqa: F401

MODELS = ["vgg16", "resnet50", "digits_vgg", "tiny_vgg", "tiny_resnet",
          "xception", "tiny_xception", "cifar_resnet20", "cifar_plain20",
          "frcnn_vgg16", "tiny_frcnn"]


def layer_tuples(g):
    return (g.name, [(t.name, tuple(t.shape)) for t in g.inputs],
            [(l.name, l.type, l.bottoms, l.tops, l.attrs) for l in g.layers])


def assert_params_equal(got, want):
    assert got.keys() == want.keys()
    for layer in want:
        assert got[layer].keys() == want[layer].keys(), layer
        for k in want[layer]:
            np.testing.assert_array_equal(np.asarray(got[layer][k]),
                                          np.asarray(want[layer][k]),
                                          err_msg=f"{layer}.{k}")


@pytest.mark.parametrize("name", MODELS)
def test_builders_give_equal_graphs(name):
    assert layer_tuples(zoo.get_model(name, batch=2)) == \
        layer_tuples(jax_zoo.get_model(name, batch=2))


def test_registry_leaves_out_only_faster_rcnn():
    """Since the Faster-RCNN builders are ported, nothing is left out: the
    port registers every model of the JAX package, with the same counts."""
    assert set(zoo.MODEL_REGISTRY) == set(jax_zoo.MODEL_REGISTRY)
    for name, entry in jax_zoo.MODEL_REGISTRY.items():
        assert (zoo.MODEL_REGISTRY[name]["flops"],
                zoo.MODEL_REGISTRY[name]["family"]) == \
            (entry["flops"], entry["family"]), name


def test_faster_rcnn_builders_and_heads_equal():
    from channel_pruning_tpu.models import faster_rcnn as jax_frcnn
    from channel_pruning_tpu_torch.models import faster_rcnn

    for kw in ({}, {"with_rpn": False, "image_size": 320, "num_anchors": 3}):
        assert layer_tuples(faster_rcnn.build_frcnn_backbone(**kw)) == \
            layer_tuples(jax_frcnn.build_frcnn_backbone(**kw))
    g, p = faster_rcnn.build_tiny_frcnn(batch=3, image_size=32, seed=5)
    g_j, p_j = jax_frcnn.build_tiny_frcnn(batch=3, image_size=32, seed=5)
    assert layer_tuples(g) == layer_tuples(g_j)
    assert_params_equal(p, p_j)
    assert [dataclasses.astuple(h) for h in faster_rcnn.frcnn_heads(g)] == \
        [dataclasses.astuple(h) for h in jax_frcnn.frcnn_heads(g_j)]
    with pytest.raises(ValueError, match="RPN"):
        faster_rcnn.frcnn_heads(faster_rcnn.build_frcnn_backbone(with_rpn=False))


@pytest.mark.parametrize("name", ["tiny_vgg", "tiny_resnet", "tiny_xception",
                                  "resnet50"])
def test_init_params_equal_from_one_seed(name):
    g, g_j = zoo.get_model(name, batch=1), jax_zoo.get_model(name, batch=1)
    assert_params_equal(vgg.init_params(g, seed=3),
                        jax_vgg.init_params(g_j, seed=3))


@pytest.mark.parametrize("name", ["vgg16", "resnet50", "tiny_resnet",
                                  "tiny_xception"])
def test_flops_equal(name):
    g, g_j = zoo.get_model(name, batch=1), jax_zoo.get_model(name, batch=1)
    for include_fc in (True, False):
        assert flops.total_flops(g, include_fc=include_fc) == \
            jax_flops.total_flops(g_j, include_fc=include_fc)
    assert flops.total_params(g) == jax_flops.total_params(g_j)


def test_tables_and_config_equal():
    assert resnet.resnet50_2x_targets() == jax_resnet.resnet50_2x_targets()
    assert vgg.VGG16_5X_CHANNELS == jax_vgg.VGG16_5X_CHANNELS
    assert dataclasses.asdict(config.default_config()) == \
        dataclasses.asdict(jax_config.default_config())
    cfg = config.default_config().replace_nested("solve.band", "bottom")
    cfg_j = jax_config.default_config().replace_nested("solve.band", "bottom")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)


PORT = (c3, resnet, rewrite)
JAX = (jax_c3, jax_resnet, jax_rewrite)


def _gated_tiny_resnet(gates, modules=PORT):
    """The preprocessed tiny ResNet with a Select gate in front of the first
    len(gates) branch2a convs, keeping the given input channels; built with
    one package's (c3, resnet, rewrite) modules."""
    c3_mod, resnet_mod, rewrite_mod = modules
    g, p = c3_mod.preprocess(*resnet_mod.build_tiny_resnet(batch=2,
                                                           image_size=32))
    p = {k: dict(v) for k, v in p.items()}
    for conv, idx in zip([c for c in g.convs if c.endswith("branch2a")], gates):
        g = rewrite_mod.insert_select(g, g.layer(conv).bottoms[0], conv,
                                      np.asarray(idx))
        p[conv]["W"] = p[conv]["W"][:, list(idx)]
    return g, p


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_caffe_files_read_back_equal_across_packages(tmp_path, writer):
    """A prototxt + caffemodel written by one package is read back equal by
    the other (gates of three or more channels, which both read alike)."""
    gates = [(1, 3, 4), (0, 2, 5, 7), (2, 3, 9)]
    g, p = _gated_tiny_resnet(gates)
    proto, model = tmp_path / "m.prototxt", tmp_path / "m.caffemodel"
    if writer == "port":
        cio.export_model(g, p, proto, model)
    else:
        g_j, p_j = _gated_tiny_resnet(gates, JAX)
        assert layer_tuples(g_j) == layer_tuples(g)
        jax_cio.export_model(g_j, p_j, proto, model)
    got, got_p = cio.import_model(proto, model)
    want, want_p = jax_cio.import_model(proto, model)
    assert layer_tuples(got) == layer_tuples(want)
    assert_params_equal(got_p, want_p)
    assert_params_equal(got_p, {k: v for k, v in p.items() if k in got_p})
    assert [l.attr("indices") for l in got.by_type(LT.SELECT)] == gates


def test_gates_of_zeros_and_ones_survive_a_round_trip(tmp_path):
    """(0,) and (0, 1) are index lists: the port reads them back as such (the
    JAX package's codec takes any 0/1 blob for a mask)."""
    g, p = _gated_tiny_resnet([(0,), (0, 1), (1,)])
    proto, model = tmp_path / "m.prototxt", tmp_path / "m.caffemodel"
    cio.export_model(g, p, proto, model)
    got, _ = cio.import_model(proto, model)
    assert [(l.attr("indices"), l.attr("num_output"))
            for l in got.by_type(LT.SELECT)] == [((0,), 1), ((0, 1), 2), ((1,), 1)]
    want, _ = jax_cio.import_model(proto, model)
    assert [l.attr("indices") for l in want.by_type(LT.SELECT)] == \
        [(), (1,), (0,)]


def test_full_width_mask_blob_still_loads_as_a_mask(tmp_path):
    """A Filter blob of 0s and 1s as long as the gate's input is the Caffe
    fork's mask form: it loads as the indices of its 1s."""
    g, p = _gated_tiny_resnet([(1, 3, 4)])
    proto, model = tmp_path / "m.prototxt", tmp_path / "m.caffemodel"
    cio.export_model(g, p, proto, model)
    gate = g.by_type(LT.SELECT)[0]
    width = p[g.consumers(gate.tops[0])[0].name]["W"].shape[1]
    in_width = cio._select_input_widths(g)[gate.name]
    assert width == 3 and in_width == 8
    mask = np.zeros(in_width, np.float32)
    mask[[1, 3, 4]] = 1.0
    _, records = cm.load_caffemodel(model)
    for r in records:
        if r.name == gate.name:
            r.blobs[0] = mask
    cm.save_caffemodel(model, g.name, records)
    got, _ = cio.import_model(proto, model)
    assert got.by_type(LT.SELECT)[0].attr("indices") == (1, 3, 4)


@pytest.mark.parametrize("writer,reader", [(SolveCheckpoint, JaxSolveCheckpoint),
                                           (JaxSolveCheckpoint, SolveCheckpoint)])
def test_solve_checkpoint_loads_across_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(0)
    state = {"p_run": {"conv1": {"W": rng.normal(size=(4, 3, 3, 3))
                                 .astype(np.float32)}},
             "selections": {"conv2": np.array([True, False, True])},
             "reports": [1, 2], "frontier_fallbacks": []}
    w = writer(tmp_path / "state.pkl", every=1)
    w.maybe_save(4, state)
    w.wait()
    idx, got = reader(tmp_path / "state.pkl").load()
    assert idx == 4 and got.keys() == state.keys()
    assert_params_equal(got["p_run"], state["p_run"])
    np.testing.assert_array_equal(got["selections"]["conv2"],
                                  state["selections"]["conv2"])
    assert got["reports"] == [1, 2]


REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["caffemodel.cpp", "preprocess.cpp"])
def test_native_sources_are_byte_copies(name):
    """The port builds its own copies of the JAX package's C++ codecs: they
    must stay byte-equal to native/."""
    assert (REPO / "channel_pruning_tpu_torch" / "csrc" / name).read_bytes() \
        == (REPO / "native" / name).read_bytes()


@pytest.mark.parametrize("shape,multiple,axis", [
    ((203, 24), 8, 0), ((16, 3), 8, 0), ((5, 7, 2), 4, 1), ((1,), 3, 0),
    ((0, 4), 8, 0)])
def test_pad_to_multiple_equals_jax(shape, multiple, axis):
    from channel_pruning_tpu.parallel import mesh as jax_mesh
    from channel_pruning_tpu_torch.parallel import mesh as mesh_mod

    x = np.random.default_rng(len(shape) * multiple).normal(size=shape) \
        .astype(np.float32)
    got, n = mesh_mod.pad_to_multiple(x, multiple, axis)
    want, n_j = jax_mesh.pad_to_multiple(x, multiple, axis)
    assert n == n_j and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
