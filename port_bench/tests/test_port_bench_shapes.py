"""The benchmark's own shape arithmetic, pinned to hand-known counts, and
the interval arithmetic behind idle_pct."""
import json

import pytest

from port_bench import shapes
from port_bench.configs import resnet50, vgg16
from port_bench.devtrace import DeviceTrace, gaps, union_seconds
from port_bench.tests.conftest import ROOT


def _config(name):
    return json.loads((ROOT / "port_bench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name, builder, mults", [
    ("vgg16", vgg16, 15_346_630_656),        # lib/cfgs.py:66
    ("resnet50", resnet50, 3_855_925_248),   # output-resolution accounting
])
def test_conv_mults_of_the_configurations(name, builder, mults):
    layers = builder.layers(_config(name))
    assert sum(shapes.conv_mults(layers, (1, 3, 224, 224)).values()) == mults


def test_resnet50_pool1_walks_in_ceil_mode():
    s = shapes.tensor_shapes(resnet50.layers(_config("resnet50")), (2, 3, 224, 224))
    assert s["pool1"] == (2, 64, 56, 56)
    assert s["pool5"] == (2, 2048, 1, 1)
    assert s["fc1000"] == (2, 1000)


@pytest.mark.parametrize("c, alphas, seconds", [
    # c = 512: bytes 4 (512^2 + 512 + 32 * 512) = 1,116,160 -> 0.3332 us;
    # flops 32 * 2 * 512^2 = 16,777,216 -> 0.2504 us: bytes bound
    (512, 32, 1_116_160 / 3.35e12),
    # c = 2048: bytes 4 (2048^2 + 2048 + 32 * 2048) = 17,047,552 -> 5.089 us;
    # flops 32 * 2 * 2048^2 = 268,435,456 -> 4.006 us: bytes bound
    (2048, 32, 17_047_552 / 3.35e12),
    # c = 2048 at 64 alphas: flops 536,870,912 -> 8.013 us; bytes 5.32 us
    (2048, 64, 536_870_912 / 67e12),
])
def test_cd_least_time(c, alphas, seconds):
    assert shapes.cd_grid_least_seconds(c, alphas) == pytest.approx(seconds, rel=1e-12)


def test_lstsq_flops():
    # rows * d (d + 1) + 2 rows d n + d^3 / 3 + 2 d^2 n at rows 10, d 3, n 2
    assert shapes.lstsq_flops(10, 3, 2) == 120 + 120 + 9 + 36


def test_interval_union_counts_overlaps_once():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (10.0, 11.0)]
    assert union_seconds(iv, 0.0, 5.0) == pytest.approx(3.0)
    assert union_seconds(iv, 1.5, 3.5) == pytest.approx(1.0)
    assert gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_device_trace_sums():
    tr = DeviceTrace(ops=[("void lasso_cd_grid_kernel<4, 2>", 1.0, 1.5),
                          ("Memcpy HtoD", 1.2, 1.4), ("gemm", 3.0, 4.0)],
                     lo=0.0, hi=5.0)
    assert tr.busy_seconds() == pytest.approx(1.5)
    assert tr.seconds_of("lasso_cd") == pytest.approx(0.5)
    assert tr.top_ops(2) == [["gemm", pytest.approx(1.0)],
                             ["void lasso_cd_grid_kernel<4, 2>", pytest.approx(0.5)]]
