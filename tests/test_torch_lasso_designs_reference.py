"""The single-task LASSO search held to the JAX package at full width on
committed designs: for VGG-16 3C 4x, Faster-RCNN 600² 5x and Xception 2x,
the Gram form (G, b) that the card's run of each path gave a layer's
search (tools/capture_group_designs.py --path) and the JAX package's
answer on the same G and b (tools/jax_reference.py --lasso-designs), under
channel_pruning_tpu_torch/reference/data. On the CPU: each artifact loads
with its sha256 and provenance; the port's fused search on the plain
version of K1 keeps the JAX mask on the smallest design of each path (the
others are `slow`: the plain version steps coordinate by coordinate in
Python, ~10 s at c = 256 and minutes at c = 728); the live JAX package
reproduces the committed answer on the smallest design of each path;
`compare_design` catches each kind of fault; and both tools round-trip the
tiny VGG in prune and in 3C mode and the host-stepped search."""
import copy
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from channel_pruning_tpu.ops import lasso as jlasso
from channel_pruning_tpu_torch import reference as ref
from torch_cpu import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

# (c, n, kh·kw) of the committed designs: the first layer of each class
# with c <= 512, and the layers where the two packages' whole-path runs
# kept masks past the bar
COMMITTED = {
    "vgg16_3c_4x": {"conv2_1": (64, 128, 9), "conv2_2": (128, 128, 9),
                    "conv3_1": (128, 256, 9), "conv3_2": (256, 256, 9),
                    "conv4_1": (256, 512, 9), "conv4_2": (512, 512, 9),
                    "conv4_3": (512, 512, 9)},
    "frcnn_600_5x": {"conv1_2": (64, 64, 9), "conv2_1": (64, 128, 9),
                     "conv2_2": (128, 128, 9), "conv3_1": (128, 256, 9),
                     "conv3_2": (256, 256, 9), "conv4_1": (256, 512, 9),
                     "conv4_2": (512, 512, 9), "rpn_conv/3x3": (512, 512, 9),
                     "rpn_cls_score": (512, 18, 1),
                     "rpn_bbox_pred": (512, 36, 1)},
    "xception_2x": {"conv2": (32, 64, 9), "entry1_shortcut": (64, 128, 1),
                    "entry1_sep2_pw": (128, 128, 1),
                    "entry2_sep1_pw": (128, 256, 1),
                    "entry2_sep2_pw": (256, 256, 1),
                    "entry3_sep1_pw": (256, 728, 1),
                    "mid1_sep3_pw": (728, 728, 1),
                    "mid3_sep1_pw": (728, 728, 1),
                    "mid6_sep1_pw": (728, 728, 1)},
}
# the searched layers of each path's run: 3C's 11 arms, Faster-RCNN's 15
# consumers, Xception's 36
SEARCHED = {"vgg16_3c_4x": 11, "frcnn_600_5x": 15, "xception_2x": 36}
SMALLEST = {"vgg16_3c_4x": "conv2_1", "frcnn_600_5x": "conv1_2",
            "xception_2x": "conv2"}
BUDGET = 20e6       # bytes of the three artifacts together


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def designs():
    return {p: ref.load_lasso_designs(p) for p in ref.LASSO_DESIGN_PATHS}


@pytest.mark.parametrize("path", sorted(COMMITTED))
def test_committed_lasso_designs_load_with_their_provenance(designs, path):
    meta, got = designs[path]
    assert meta["path"] == path
    assert {k: (d.meta["c"], d.meta["n"], d.meta["khkw"]) for k, d in got.items()} \
        == COMMITTED[path]
    for d in got.values():
        rec, c = d.meta, d.meta["c"]
        assert d.G.shape == (c, c) and d.b.shape == (c,)
        assert d.G.dtype == d.b.dtype == np.float32
        assert rec["search"] == "fused" and rec["n_samples"] % rec["n"] == 0
        assert rec["args"]["prefer"] == "bottom" and rec["args"]["n_sweeps"] == 200
        assert rec["args"]["max_rounds"] == 8
        # the bottom of the band lands on the target in both packages
        assert rec["card"]["count"] == rec["jax"]["count"] == rec["args"]["rank"]
        assert ref.unpack_mask(rec["card"]["mask"]).sum() == rec["args"]["rank"]
        assert rec["jax"]["seconds"] > 0 and rec["card"]["grids"] >= 1
    prov = meta["provenance"]
    assert "H100" in prov["card"] and prov["spec"] == ref.spec_for(path)
    assert prov["jax_answer"]["devices"] == 1 and prov["jax_answer"]["jax"]
    assert "bit for bit" in prov["self_check"]
    # every searched layer is committed or listed as left out, with (c, n)
    assert len(got) + len(prov["left_out"]) == SEARCHED[path]
    assert not set(got) & set(prov["left_out"])
    assert set(prov["named"]) <= set(got)
    assert all(c > 512 or (c, n) in {v[:2] for v in COMMITTED[path].values()}
               for c, n in prov["left_out"].values())


def test_committed_lasso_designs_fit_their_budget():
    size = sum((ref.DATA / f"{ref.lasso_designs_stem(p)}.{ext}").stat().st_size
               for p in ref.LASSO_DESIGN_PATHS for ext in ("json", "npz"))
    assert size <= BUDGET


@pytest.mark.parametrize("path,name", [
    (p, n) if n == SMALLEST[p] else pytest.param(p, n, marks=pytest.mark.slow)
    for p in sorted(COMMITTED) for n in COMMITTED[p]])
def test_port_plain_search_keeps_the_jax_mask(designs, path, name):
    d = designs[path][1][name]
    mask, alpha, count = ref.solve_lasso(d, "cpu")
    gap = ref.compare_design(d, mask, alpha, count)
    assert not gap.faults, gap.line()


@pytest.mark.parametrize("path", sorted(COMMITTED))
def test_live_jax_package_reproduces_the_committed_answer(designs, path):
    d = designs[path][1][SMALLEST[path]]
    gram = jlasso.LassoGram(jnp.asarray(d.G), jnp.asarray(d.b),
                            d.meta["n_samples"])
    mask, alpha, count = jlasso.fused_search_alpha(gram, **d.args)
    want = d.meta["jax"]
    assert count == want["count"]
    np.testing.assert_array_equal(mask, ref.unpack_mask(want["mask"]))
    assert alpha == pytest.approx(want["alpha"], rel=1e-6)


def _swapped(entry, k):
    """The mask of `entry` with k kept channels swapped for dropped ones."""
    m = ref.unpack_mask(entry)
    kept, dropped = np.flatnonzero(m), np.flatnonzero(~m)
    m[kept[:k]], m[dropped[:k]] = False, True
    return m


@pytest.mark.parametrize("kind,faults,apart", [
    ("same", 0, 0), ("swap2", 0, 2), ("swap3", 1, 3), ("count", 1, 1),
    ("width", 1, 0)])
def test_compare_design_holds_counts_and_masks(designs, kind, faults, apart):
    d = designs["frcnn_600_5x"][1]["conv1_2"]      # c = 64: a bar of 2 channels
    want = d.meta["jax"]
    mask = ref.unpack_mask(want["mask"])
    count = want["count"]
    if kind.startswith("swap"):
        mask = _swapped(want["mask"], int(kind[-1]))
    elif kind == "count":
        mask[np.flatnonzero(mask)[0]] = False
        count -= 1
    elif kind == "width":
        mask = np.concatenate([mask, [False]])
    gap = ref.compare_design(d, mask, want["alpha"] * 1.5, count)
    assert (len(gap.faults), gap.apart, gap.bar) == (faults, apart, 2)
    assert gap.alpha_gap == pytest.approx(0.5)


def test_the_bar_grows_with_the_width(designs):
    """At c = 728 the bar is 7 channels: 7 apart pass, 8 do not."""
    d = designs["xception_2x"][1]["mid1_sep3_pw"]
    want = d.meta["jax"]
    for k, faults in ((7, 0), (8, 1)):
        gap = ref.compare_design(d, _swapped(want["mask"], k), want["alpha"],
                                 want["count"])
        assert (gap.bar, gap.apart, len(gap.faults)) == (7, k, faults)


TINY = ["prune", "--model", "tiny_vgg", "--batch", "4", "--cal-batches", "4",
        "--cal-batch", "4", "--speed", "2.0", "--set", "solve.band=bottom"]


@pytest.mark.parametrize("extra,search,n_designs", [
    ([], "fused", 5), (["--mode", "3c"], "fused", 4),
    (["--set", "solve.fused_search=False"], "host", 5)])
def test_both_tools_round_trip_the_tiny_vgg(tmp_path, extra, search, n_designs):
    """The card's capture on the CPU (tiny VGG: the pipelined pass, the 3C
    arms, the sequential host-stepped search) and the JAX package's answer
    on its designs: the same masks in both packages, the capture's
    self-check passed, `--max-c` leaving layers out."""
    capture, jax_reference = _tool("capture_group_designs"), _tool("jax_reference")
    stem = tmp_path / "designs"
    assert capture.main([
        "--kind", "lasso", "--out", str(stem), "--work", str(tmp_path / "work"),
        "--device", "cpu", "--max-c", "8", "--layers", "conv3_2",
        "--", *TINY, *extra]) == 0
    meta = json.loads(stem.with_suffix(".json").read_text())
    prov = meta["provenance"]
    assert "conv3_2" in meta["designs"]
    assert len(meta["designs"]) + len(prov["left_out"]) == n_designs
    assert prov["left_out"] and all(c > 8 for c, n in prov["left_out"].values())
    out = tmp_path / "answered"
    jax_reference.main(["--lasso-designs", str(stem.with_suffix(".npz")),
                        "--out", str(out), "--note", "why=test"])
    meta2, got = ref.load_lasso_designs(out)
    assert list(got) == list(meta["designs"])
    assert meta2["provenance"]["left_out"] == prov["left_out"]
    assert meta2["provenance"]["jax_answer"]["notes"] == {"why": "test"}
    for d in got.values():
        assert d.meta["search"] == search
        card = d.meta["card"]
        gap = ref.compare_design(d, ref.unpack_mask(card["mask"]),
                                 card["alpha"], card["count"])
        assert gap.apart == 0 and not gap.faults, gap.line()
        mask, alpha, count = ref.solve_lasso(d, "cpu")
        assert np.array_equal(mask, ref.unpack_mask(card["mask"]))
        assert (alpha, count) == (card["alpha"], card["count"])
    bad = copy.deepcopy(meta2)
    bad["designs"]["conv3_2"]["sha256"]["G"] = "0" * 64
    out.with_suffix(".json").write_text(json.dumps(bad))
    with pytest.raises(ref.ReferenceFault, match="sha256"):
        ref.load_lasso_designs(out)


def test_capture_refuses_a_named_layer_it_did_not_search(tmp_path):
    capture = _tool("capture_group_designs")
    with pytest.raises(AssertionError, match="no single-task search"):
        capture.main(["--kind", "lasso", "--out", str(tmp_path / "d"),
                      "--work", str(tmp_path / "work"), "--device", "cpu",
                      "--layers", "conv9_9", "--", *TINY])
