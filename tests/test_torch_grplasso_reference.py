"""The group lasso (`dic.grplasso=true`) held to the JAX package at full
width on committed designs: for ResNet-50 2x's 1x1 consumers, the 250
rows a group search solved on the card (tools/capture_group_designs.py)
and the JAX package's answer on the same rows (tools/jax_reference.py
--group-designs), under channel_pruning_tpu_torch/reference/data. On the
CPU: the artifact loads with its sha256 and provenance; the port's search
on the plain version of K3 keeps the JAX mask on the two smallest designs,
(64, 64) and (64, 256) (the others are `slow`: the plain version steps
row by row in Python, ~0.3-1.5 ms a row step, so (256, 64)'s two
200-sweep grids take minutes on a loaded CPU); the live JAX package
reproduces the committed answer; `compare_group` catches each kind of
fault; and both tools round-trip the tiny ResNet."""
import copy
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from channel_pruning_tpu.ops import lasso as jlasso
from channel_pruning_tpu_torch import reference as ref

REPO = Path(__file__).resolve().parent.parent

# (c, n) of the committed designs: the first layer of each class whose JAX
# solve fits a CPU run
COMMITTED = {"res2a_branch2a": (64, 64), "res2a_branch2c": (64, 256),
             "res2b_branch2a": (256, 64), "res3a_branch2a": (256, 128),
             "res3a_branch2c": (128, 512), "res3b_branch2a": (512, 128),
             "res4a_branch2a": (512, 256), "res4a_branch2c": (256, 1024),
             "res4b_branch2a": (1024, 256)}
SMALL = ("res2a_branch2a", "res2a_branch2c")
N_1X1 = 32          # ResNet-50's 16 gates and 16 branch2c consumers


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def designs():
    return ref.load_group_designs()


@pytest.fixture
def one_thread():
    """The plain version's row loop is bound by op dispatch: more threads
    only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_committed_designs_load_with_their_provenance(designs):
    meta, got = designs
    assert set(COMMITTED) <= set(got)
    for name, d in got.items():
        rec = d.meta
        assert d.X.shape == (250, rec["c"]) and d.Y.shape == (250, rec["n"])
        assert d.X.dtype == d.Y.dtype == np.float32
        assert COMMITTED.get(name, d.shape) == d.shape
        assert rec["args"]["prefer"] == "bottom" and rec["args"]["n_sweeps"] == 200
        # the bottom of the band lands on the target in both packages
        assert rec["card"]["count"] == rec["jax"]["count"] == rec["args"]["rank"]
        assert ref.unpack_mask(rec["jax"]["mask"]).sum() == rec["args"]["rank"]
        assert rec["jax"]["seconds"] > 0 and rec["card"]["grids"] >= 1
    prov = meta["provenance"]
    assert "H100" in prov["card"] and "dic.grplasso=true" in prov["cli"]
    assert prov["jax_answer"]["devices"] == 1 and prov["jax_answer"]["jax"]
    # every captured 1x1 design is committed or listed as left out
    assert len(got) + len(prov["left_out"]) == N_1X1
    assert not set(got) & set(prov["left_out"])


@pytest.mark.parametrize("name", [
    n if n in SMALL else pytest.param(n, marks=pytest.mark.slow)
    for n in COMMITTED])
def test_port_plain_search_keeps_the_jax_mask(designs, one_thread, name):
    d = designs[1][name]
    mask, alpha, count = ref.solve_group(d, "cpu")
    gap = ref.compare_group(d, mask, alpha, count)
    assert not gap.faults, gap.line()


def test_live_jax_package_reproduces_the_committed_answer(designs):
    d = designs[1]["res2a_branch2a"]
    gram = jlasso.group_gram(jnp.asarray(d.X), jnp.asarray(d.Y))
    mask, alpha, count = jlasso.search_alpha_group(gram, **d.args)
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
    ("same", 0, 0), ("swap2", 0, 2), ("swap3", 1, 3), ("count", 1, 1)])
def test_compare_group_holds_counts_and_masks(designs, kind, faults, apart):
    d = designs[1]["res2a_branch2a"]          # c = 64: a bar of 2 channels
    want = d.meta["jax"]
    mask = ref.unpack_mask(want["mask"])
    count = want["count"]
    if kind.startswith("swap"):
        mask = _swapped(want["mask"], int(kind[-1]))
    elif kind == "count":
        mask[np.flatnonzero(mask)[0]] = False
        count -= 1
    gap = ref.compare_group(d, mask, want["alpha"] * 1.5, count)
    assert (len(gap.faults), gap.apart, gap.bar) == (faults, apart, 2)
    assert gap.alpha_gap == pytest.approx(0.5)


def test_both_tools_round_trip_the_tiny_resnet(tmp_path):
    """The card's capture on the CPU (tiny ResNet, grplasso) and the JAX
    package's answer on its designs: one design a 1x1 consumer, the rows
    as `row_subsample` draws them, and the same masks in both packages."""
    capture, jax_reference = _tool("capture_group_designs"), _tool("jax_reference")
    stem = tmp_path / "designs"
    assert capture.main([
        "--out", str(stem), "--work", str(tmp_path / "work"), "--device", "cpu",
        "--", "prune", "--model", "tiny_resnet", "--batch", "4",
        "--cal-batches", "4", "--cal-batch", "4", "--speed", "1.2",
        "--set", "dic.grplasso=true"]) == 0
    meta = json.loads(stem.with_suffix(".json").read_text())
    assert len(meta["designs"]) == 6        # res2a_branch1 and five more 1x1
    out = tmp_path / "answered"
    jax_reference.answer_group_designs(stem.with_suffix(".npz"),
                                       ["res2a_branch2a", "res3b_branch2c"],
                                       out, {"why": "test"})
    meta2, got = ref.load_group_designs(out)
    assert list(got) == ["res2a_branch2a", "res3b_branch2c"]
    assert len(meta2["provenance"]["left_out"]) == 4
    for d in got.values():
        assert d.X.shape[0] == 8            # min(400, N // 20) rows
        gap = ref.compare_group(d, ref.unpack_mask(d.meta["card"]["mask"]),
                                d.meta["card"]["alpha"], d.meta["card"]["count"])
        assert gap.apart == 0 and not gap.faults
    bad = copy.deepcopy(meta2)
    bad["designs"]["res2a_branch2a"]["sha256"]["X"] = "0" * 64
    (out.with_suffix(".json")).write_text(json.dumps(bad))
    with pytest.raises(ref.ReferenceFault, match="sha256"):
        ref.load_group_designs(out)
