"""Xception 2x at 299² as a benchmark cell (`xception.cp2x`): the port's
forward of the tiny Xception after `c3.preprocess` against the benchmark's
plain reference on the same weights; the configuration's plain layer list at
299² against the port's graph; the cell's files as the harness loads them,
its traffic's targets against the port's planner; and the readers of the
depthwise conv metrics on a hand-built trace."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from channel_pruning_tpu_torch.convert import params_to_torch
from channel_pruning_tpu_torch.graph import rewrite
from channel_pruning_tpu_torch.graph.ir import shapes_of
from channel_pruning_tpu_torch.models import zoo
from channel_pruning_tpu_torch.models.vgg import init_params
from channel_pruning_tpu_torch.models.xception import build_tiny_xception
from channel_pruning_tpu_torch.ops.forward import run_graph
from channel_pruning_tpu_torch.pipeline import c3
from port_bench import harness, shapes
from port_bench.configs import xception
from port_bench.devtrace import DeviceTrace
from port_bench.metrics import dwconv_ms, dwconv_roofline_pct
from port_bench.reference import plain
from torch_cpu import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
CELL = "xception.cp2x"
CONFIG = json.loads((REPO / "port_bench" / "configs" / "xception.json").read_text())
# the widths of `build_tiny_xception` (width 0.125, two middle blocks)
TINY = {"stem_widths": [8, 8], "entry_widths": [16, 32, 91],
        "middle_blocks": 2, "exit_widths": [91, 128, 192, 256],
        "num_classes": 10, "bn_eps": 1e-9}


def _out_of_place(layers):
    """The layer list with each in-place layer (BatchNorm, Scale) writing a
    tensor of its own and every later reader pointed at it; and {tensor
    name: the tensor holding its last value}."""
    alias, out = {}, []
    for l in layers:
        in_place = bool(l["tops"]) and l["tops"][0] in l["bottoms"]
        l = dict(l, bottoms=[alias.get(b, b) for b in l["bottoms"]])
        if in_place:
            alias[l["tops"][0]] = f"{l['name']}:out"
            l["tops"] = [alias[l["tops"][0]]]
        out.append(l)
    return out, alias


def test_port_forward_equals_the_plain_reference():
    """Every conv's output of the port's forward (BatchNorm folded by
    `c3.preprocess`) against the plain reference running the unfolded net
    at ε = 1e-9, the ε the fold uses, on the same weights and images:
    max|difference| / RMS ≤ 1e-5. Both run in f32 on the CPU, so they
    differ only in summation order and in the fold's rounding (4.2e-6 at
    the last conv here, compounding down the net); a bf16 forward reads
    1.1e-2 to 7.3e-2, and the reference at the ε of 1e-5 that
    `models/xception.py` states reads 6.4e-4."""
    g0, p0 = build_tiny_xception(batch=2, image_size=32, seed=3)
    g, p = c3.preprocess(g0, p0)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (2, 3, 32, 32)).astype(np.float32))
    convs = list(g.convs)
    _, got = run_graph(g, params_to_torch(p, "cpu"), {"data": x}, capture=convs)

    layers, alias = _out_of_place(xception.layers(TINY))
    params = {k: {n: torch.from_numpy(np.asarray(v, np.float32))
                  for n, v in d.items()} for k, d in p0.items()}
    ref = plain.run(layers, params, x, {alias.get(c, c): lambda v: v
                                         for c in convs})
    assert len(convs) == 74 - 6 * 6        # two middle blocks, not eight
    for c in convs:
        want = ref[alias.get(c, c)]
        gap = float((got[c] - want).abs().max() / want.pow(2).mean().sqrt())
        assert gap <= 1e-5, (c, gap)


def test_the_configuration_is_the_ports_graph_at_299():
    """The configuration's plain layer list at 299²: the port's layer names
    and tensor shapes, 34 depthwise convs, 8,468,704,656 conv mults."""
    layers = xception.layers(CONFIG)
    size = int(CONFIG["image_size"])
    port = rewrite.split_relu(zoo.get_model(CONFIG["program_model"], batch=1,
                                            image_size=size))
    assert [l["name"] for l in layers] == [l.name for l in port.layers]
    want = shapes_of(port, batch=1)
    got = shapes.tensor_shapes(layers, (1, 3, size, size))
    assert {t: got[t] for t in want} == {t: tuple(s) for t, s in want.items()}
    one = (1, 3, size, size)
    assert len(dwconv_roofline_pct.depthwise_convs(layers, one)) == 34
    assert sum(shapes.conv_mults(layers, one).values()) == 8_468_704_656


def test_the_cell_loads_and_plans_as_the_cli():
    """The harness loads `xception.cp2x`; its traffic's targets are what
    `cli prune --model xception --speed 2.0` plans at 299² (rank_tol 0.1),
    its limits hold all five numbers, and its per-layer metrics include the
    depthwise conv's two."""
    cell = harness.load_cell(REPO, CELL)
    assert cell.chips == 1 and cell.traffic["mode"] == "prune"
    assert cell.config["head"] in {l["name"] for l in cell.layers()}
    assert set(cell.limits) == {"freeze_gap", "counts_off", "select_off",
                                "refit_excess", "depthwise_off"}
    assert {"dwconv_ms", "dwconv_roofline_pct", "cd_ms", "mfu_pct",
            "idle_pct"} <= {m["name"] for m in cell.per_layer}
    g0 = zoo.get_model("xception", batch=1, image_size=299)
    g, _ = c3.preprocess(g0, init_params(g0, seed=0))
    plan = c3.plan_uniform_targets(g, 2.0, rank_tol=0.1)
    assert cell.traffic["channel_targets"] == plan
    assert len(plan) == 74


def _ctx(ops, jobs=2):
    cell = harness.load_cell(REPO, CELL)
    orig = cell.layers()
    return harness.Context(cell=cell, orig=orig, out=orig,
                           window_jobs=list(range(jobs)),
                           trace=DeviceTrace(ops=ops, lo=0.0, hi=10.0))


def test_depthwise_readers_on_a_hand_built_trace():
    """`dwconv_ms` sums the kernels named `conv_depthwise2d` a job;
    `dwconv_roofline_pct` is the depthwise convs' least time (the freeze's
    over the 500 images, and the replays' up to the last solved layer)
    over it. Untraced, or with no such kernel, both read nothing."""
    kern = "void at::native::conv_depthwise2d_forward_kernel<3, float, int>"
    ops = [(kern, 1.0, 1.05), ("sm90_xmma_fprop", 1.05, 1.2), (kern, 2.0, 2.15)]
    ctx = _ctx(ops)
    assert dwconv_ms.read(ctx) == pytest.approx(1e3 * 0.2 / 2)
    one = (1, 3, 299, 299)
    freeze = dwconv_roofline_pct.least_seconds(ctx.orig, one, 500)
    # ~120 MB of f32 input and output an image at 3.35 TB/s
    assert freeze == pytest.approx(0.0179, rel=0.01)
    least = dwconv_roofline_pct.job_least_seconds(ctx)
    # the uncompressed net's replays: every depthwise conv up to
    # exit_sep4_pw's input
    assert least == pytest.approx(2 * freeze)
    assert dwconv_roofline_pct.read(ctx) == pytest.approx(100 * least / 0.1)
    assert dwconv_ms.read(_ctx(ops[1:2])) is None
    assert dwconv_roofline_pct.read(_ctx(ops[1:2])) is None
    untraced = _ctx(ops)
    untraced.trace = None
    assert dwconv_ms.read(untraced) is None
    assert dwconv_roofline_pct.read(untraced) is None
