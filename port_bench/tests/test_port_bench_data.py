"""The harness finds each cell, configuration, traffic mix, limit file and
metric by name, and a cell added as files alone is picked up."""
import json

import pytest

from port_bench import harness
from port_bench.tests.conftest import ROOT, write_root


def test_every_cell_of_the_benchmark_loads():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        assert cell.chips == w["chips"]
        assert cell.traffic["mode"] == "prune"
        assert {"freeze_gap", "counts_off"} <= set(cell.limits)
        names = {l["name"] for l in cell.layers()}
        assert cell.config["head"] in names
        assert cell.end_to_end and cell.per_layer


def test_every_metric_has_a_reader():
    import importlib
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(importlib.import_module(f"port_bench.metrics.{m['name']}").read)


def test_a_cell_added_as_files_alone_is_picked_up(tmp_path):
    root = write_root(tmp_path, {"tvgg.tcp2": ("tvgg", "tcp2")})
    base = root / "port_bench"
    t = json.loads((base / "traffic" / "tcp.json").read_text())
    t["channel_targets"] = {"conv1_1": 4}
    (base / "traffic" / "tcp2.json").write_text(json.dumps(t))
    (base / "limits" / "tvgg.tcp2.json").write_text(json.dumps({"counts_off": 0}))
    cell = harness.load_cell(root, "tvgg.tcp2")
    assert cell.traffic["channel_targets"] == {"conv1_1": 4}
    assert cell.config["program_model"] == "tiny_vgg"
    assert cell.limits == {"counts_off": 0}


def test_unknown_workload_is_refused(tiny_root):
    with pytest.raises(SystemExit):
        harness.load_cell(tiny_root, "nope.nope")
