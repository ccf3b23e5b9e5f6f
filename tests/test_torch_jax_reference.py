"""The JAX reference answer (tools/jax_reference.py) and the port's check
against it (channel_pruning_tpu_torch/reference).

* Round trip on the tiny models: the JAX package's `cli prune` on the CPU
  writes an artifact, then the port's `cli prune` on the CPU, on the same
  regenerated numpy images, passes `compare` with every mask equal and a
  freeze gap of at most 1e-5 of a tensor's RMS. The 3C, Xception and
  Faster-RCNN cases run at `solve.band=bottom`, as their full-size paths
  do (tiny_xception under `-m slow`); there every count lands on its
  target: the plan's, or a 3C arm's floor(c / 1.15).
* `compare` raises on each kind of fault, naming the layer or tensor.
* Each committed artifact loads, keeps the released tables' counts, and
  its images', weights' and point plan's sha256 equal what the port
  regenerates.
* `-m slow`: the port on the CPU at full size (VGG-16 5x, 224², 50 x 10
  images) against the committed vgg16_5x artifact.
"""
import copy
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from channel_pruning_tpu_torch import cli
from channel_pruning_tpu_torch import reference as ref
from channel_pruning_tpu_torch.models.resnet import (RESNET50_2X_BRANCH2A,
                                                     RESNET50_2X_BRANCH2B,
                                                     RESNET50_2X_FILTERS)
from channel_pruning_tpu_torch.models.vgg import VGG16_5X_CHANNELS
from channel_pruning_tpu_torch.pipeline import c3
from channel_pruning_tpu_torch.pipeline.prune import producer_conv
from channel_pruning_tpu_torch.sampling.sampler import FrozenCache

REPO = Path(__file__).resolve().parent.parent
# 4 x 4 images; the 3C chain on 16 x 4: on 4 x 4 and 8 x 4 (160 and 320
# rows a layer) its last decomposition lands 2.3-4.2e-2 from the JAX
# package's rMSE with every count and mask equal (the ITQ and VH refits of
# earlier layers give gauge-equivalent factors whose f32 rounding the later
# fits amplify; the JAX package's own tiny answers move when its sums are
# split over 8 host devices), on 16 x 4 within 1.4e-4
#
# The other three run as the full-size paths that take the bottom of the
# band (reference.PATHS): 3C, tiny_xception at 64² (16 x 4 images: 640 rows
# for its widest, 192-channel refit) and tiny_frcnn at 48² (8 x 2 images)
# with its RPN conv cut to 32 outputs in both packages' model zoos, so that
# the two 1x1 heads it feeds have fewer columns than the 160 rows
BOTTOM = ["solve.band=bottom"]
TINY = {
    "tiny_vgg": dict(model="tiny_vgg", speed=2.0),
    "tiny_resnet": dict(model="tiny_resnet", speed=1.2),
    "tiny_3c": dict(model="tiny_vgg", mode="3c", speed=2.0, cal_batches=16),
    "tiny_3c_bottom": dict(model="tiny_vgg", mode="3c", speed=2.0,
                           cal_batches=16, set=BOTTOM),
    "tiny_xception": dict(model="tiny_xception", speed=2.0, image_size=64,
                          cal_batches=16, set=BOTTOM),
    "tiny_frcnn": dict(model="tiny_frcnn", speed=5.0, image_size=48, batch=2,
                       cal_batches=8, cal_batch=2, set=BOTTOM),
}
COMMITTED = ["vgg16_5x", "resnet50_2x"]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "jax_reference", REPO / "tools" / "jax_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_run(art, work: Path):
    """The port's `cli prune` on the CPU on the artifact's regenerated
    inputs; (result, frozen cache)."""
    inp = ref.inputs(art)
    res = cli.main([*ref.cli_args(art.spec), "--device", "cpu",
                    "--work-dir", str(work)], cal_inputs=inp.images)
    s = art.spec
    return res, FrozenCache.load(work / f"frozen_{s['cal_batches']}x{s['cal_batch']}.npz")


def _narrow_rpn_builder(faster_rcnn, rewrite, width=32):
    """tiny_frcnn's zoo builder with its RPN conv cut to `width` outputs
    and the two heads' inputs to match (either package's modules)."""
    def build(**kw):
        g, p = faster_rcnn.build_tiny_frcnn(**kw)
        rpn = p["rpn_conv/3x3"]
        g, p = rewrite.set_conv(g, p, "rpn_conv/3x3", W=np.asarray(rpn["W"])[:width],
                                b=np.asarray(rpn["b"])[:width])
        for head in ("rpn_cls_score", "rpn_bbox_pred"):
            g, p = rewrite.set_conv(g, p, head,
                                    W=np.asarray(p[head]["W"])[:, :width])
        return g
    return build


@pytest.fixture
def narrow_rpn(monkeypatch):
    """Both packages' zoos build tiny_frcnn with a 32-wide RPN conv."""
    from channel_pruning_tpu.graph import rewrite as jax_rewrite
    from channel_pruning_tpu.models import faster_rcnn as jax_frcnn
    from channel_pruning_tpu.models import zoo as jax_zoo
    from channel_pruning_tpu_torch.graph import rewrite
    from channel_pruning_tpu_torch.models import faster_rcnn, zoo

    for z, fr, rw in ((jax_zoo, jax_frcnn, jax_rewrite),
                      (zoo, faster_rcnn, rewrite)):
        monkeypatch.setitem(z.MODEL_REGISTRY, "tiny_frcnn",
                            {**z.MODEL_REGISTRY["tiny_frcnn"],
                             "build": _narrow_rpn_builder(fr, rw)})


def _round_trip(name, tmp: Path):
    spec = ref.spec_for(name, **{"batch": 4, "cal_batches": 4, "cal_batch": 4,
                                 **TINY[name]})
    _tool().produce(name, spec, tmp / "jax", tmp / "art" / name)
    art = ref.load(tmp / "art" / name)
    res, cache = _port_run(art, tmp / "port")
    return art, res, cache


# tiny_xception's round trip takes ~70 s on an 8-core CPU (the port's plain
# CD over 18 consumers), past what tier-1 affords it
SLOW_TINY = {"tiny_xception"}


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow) if n in SLOW_TINY else n
    for n in sorted(TINY)])
def test_round_trip_tiny(name, tmp_path, request):
    if name == "tiny_frcnn":
        request.getfixturevalue("narrow_rpn")
    art, res, cache = _round_trip(name, tmp_path)
    rep = ref.compare(art, res, cache)
    assert rep.n_layers == len(res.reports) > 0
    assert rep.counts_equal == rep.n_layers
    assert rep.masks_equal == rep.n_masks > 0
    assert rep.freeze_gap <= 1e-5
    assert rep.n_tensors == len(art.meta["freeze"]["tensors"])
    assert art.meta["conv_mults"]["after"] < art.meta["conv_mults"]["before"]
    if "solve.band=bottom" in art.spec["set"]:
        # the bottom of the band lands on each target
        kept = _kept_by_target(art, ref.inputs(art).graph)
        assert kept and all(k == t for k, t in kept.values()), kept


@pytest.fixture(scope="module")
def tiny_vgg(tmp_path_factory):
    return _round_trip("tiny_vgg", tmp_path_factory.mktemp("ref"))


def _swap(art, k, n):
    """Swap n kept channels of selection k for n dropped ones."""
    e = art.meta["selections"][k]
    kept = set(e["kept"])
    dropped = [i for i in range(e["total"]) if i not in kept]
    e["kept"] = sorted(e["kept"][n:] + dropped[:n])


def _fault(kind, art):
    art = copy.deepcopy(art)
    layer = art.layers[2]["conv"]
    if kind == "count":
        art.layers[2]["kept"] += 1
        return art, layer
    if kind == "swap3":
        _swap(art, layer, 3)
        art.layers[2]["rmse_after"] *= 1.5
        return art, layer
    if kind == "mean":
        t = sorted(art.digest)[1]
        mean, rms = art.digest[t]
        mean = mean.copy()
        mean[0] += 1e-3 * np.sqrt(np.mean(rms ** 2))
        art.digest[t] = (mean, rms)
        return art, t
    if kind == "image_sha":
        art.meta["sha256"]["images"] = "0" * 64
        return art, "images"
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["count", "swap3", "mean", "image_sha"])
def test_compare_catches_fault(kind, tiny_vgg):
    art, res, cache = tiny_vgg
    bad, name = _fault(kind, art)
    with pytest.raises(ref.ReferenceFault, match=name):
        ref.compare(bad, res, cache)
    rep = ref.compare(bad, res, cache, raise_on_fault=False)
    assert rep.faults and all(name in f for f in rep.faults)
    if kind == "image_sha":
        with pytest.raises(ref.ReferenceFault, match="images"):
            ref.inputs(bad)


def test_compare_reports_gaps_within_the_bars(tiny_vgg):
    """One swapped pair and a 5e-3 rMSE drift are measured and reported,
    not faults (bars max(2, 1%) channels and 1e-2)."""
    art, res, cache = tiny_vgg
    art = copy.deepcopy(art)
    layer = art.layers[2]["conv"]
    _swap(art, layer, 1)
    art.layers[2]["rmse_after"] *= 1.005
    rep = ref.compare(art, res, cache)
    assert not rep.faults
    assert rep.mask_gaps[layer] == 1
    assert rep.masks_equal == rep.n_masks - 1
    assert rep.rmse_gap_at == layer and 4e-3 < rep.rmse_gap < 6e-3
    assert any(layer in line for line in rep.lines)


def test_cal_inputs_must_match_the_calibration_shape(tmp_path):
    """`cli.main(cal_inputs=)` takes only a (cal_batches, cal_batch, C, H,
    W) array of the model's input shape."""
    spec = ref.spec_for("tiny", model="tiny_vgg", batch=4, cal_batches=4,
                        cal_batch=4, speed=2.0)
    wrong = ref.images((4, 4, 3, 8, 8))
    with pytest.raises(ValueError, match="calibration array of shape"):
        cli.main([*ref.cli_args(spec), "--device", "cpu", "--work-dir",
                  str(tmp_path)], cal_inputs=wrong)


def test_hashes_see_dtype_shape_and_order():
    a = ref.images((2, 3), seed=5)
    assert ref.sha256_array(a) == ref.sha256_array(ref.images((2, 3), seed=5))
    assert ref.sha256_array(a) != ref.sha256_array(a.reshape(3, 2))
    assert ref.sha256_array(a) != ref.sha256_array(a.astype(np.float64))
    p = {"l1": {"W": a, "b": a[0]}}
    assert ref.weights_sha(p) != ref.weights_sha({"l1": {"W": a, "b": a[1]}})
    plan = {"t1": (np.zeros((2, 3), np.int32), np.ones((2, 3), np.int32))}
    assert ref.plan_sha(plan) != ref.plan_sha({"t1": plan["t1"][::-1]})


def _kept_by_target(art, graph) -> dict[str, tuple[int, int]]:
    """{layer: (kept, target)} of a prune artifact, or of a 3C
    artifact's arms: the released tables (VGG-16 5x, ResNet-50 2x), a 3C
    arm's floor(c / dic.c_ratio), elsewhere the plan's target of the
    consumer's producer conv in the port's preprocessed `graph`."""
    out = {}
    if art.spec["mode"] == "3c":
        ratio = art.meta["config"]["dic"]["c_ratio"]
        for row in art.layers:
            if row["kept"] is not None:
                out[row["conv"]] = (row["kept"], int(row["total"] // ratio))
        return out
    if art.meta["path"] == "vgg16_5x":
        for row, (conv, t) in zip(art.layers, VGG16_5X_CHANNELS.items()):
            out[conv] = (row["kept"], t)
        return out
    if art.meta["path"] == "resnet50_2x":
        for row in art.layers:
            c = row["conv"]
            if c.endswith("branch2a"):
                t = RESNET50_2X_FILTERS[c]
            elif c.endswith("branch2b"):
                t = RESNET50_2X_BRANCH2A[c.replace("branch2b", "branch2a")]
            else:
                t = RESNET50_2X_BRANCH2B[c.replace("branch2c", "branch2b")]
            out[c] = (row["kept"], t)
        return out
    plan = c3.plan_uniform_targets(graph, art.spec["speed"],
                                   rank_tol=art.meta["config"]["dic"]["rank_tol"])
    assert plan == art.meta["targets"]["channel_targets"]
    for row in art.layers:
        c = row["conv"]
        out[c] = (row["kept"], plan[producer_conv(graph, graph.layer(c).bottoms[0],
                                                  before=c)])
    return out


@pytest.mark.parametrize("path", COMMITTED)
def test_committed_artifact(path):
    art = ref.load(path)
    assert art.meta["path"] == path and art.spec == ref.spec_for(path)
    assert art.meta["shapes"]["images"][:2] == [art.spec["cal_batches"],
                                                art.spec["cal_batch"]]
    # images, weights and plan regenerated by the port: equal sha256
    inp = ref.inputs(art)
    kept = _kept_by_target(art, inp.graph)
    if path == "vgg16_5x":
        assert len(art.layers) == 10
        assert all(k == t for k, t in kept.values()), kept
    else:
        # tools/band_check.py's released band [t, round(1.1 t)]
        assert len(art.layers) == 40
        assert all(t <= k <= round(1.1 * t) for k, t in kept.values()), kept
    for row in art.layers:
        assert 0 <= row["rmse_after"] < np.inf
    for k, e in art.selections.items():
        assert len(e["kept"]) == len(set(e["kept"])) and max(e["kept"]) < e["total"]
    assert set(art.digest) == set(art.meta["freeze"]["tensors"])
    size = sum((ref.DATA / f"{path}{s}").stat().st_size for s in (".json", ".npz"))
    assert size < 1 << 20


@pytest.mark.slow
def test_vgg16_5x_224_cpu_matches_reference(tmp_path):
    """The port on the CPU at full size against the committed JAX answer:
    every mask equal, rMSEs within 1e-3 relative (the bar of
    test_vgg16_64px_rmse_matches_jax). No JAX needed."""
    art = ref.load("vgg16_5x")
    res, cache = _port_run(art, tmp_path)
    rep = ref.compare(art, res, cache)
    print(rep.summary())
    assert rep.counts_equal == rep.n_layers == 10
    assert rep.masks_equal == rep.n_masks == 10
    assert rep.rmse_gap <= 1e-3
