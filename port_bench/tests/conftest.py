"""Tiny cells of the benchmark, made as files in a temporary checkout root,
for driving the harness on the CPU. The harness's own code comes from this
repository; the cell's data (BENCHMARK.json, configuration, traffic,
limits) from the temporary root, as a later change would add them."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CONFIGS = {
    "tvgg": {"name": "tvgg", "program_model": "tiny_vgg", "reference": "vgg16",
             "image_size": 16, "stages": [[1, 2, 8], [2, 2, 12], [3, 2, 16]],
             "fc_dims": [32], "num_classes": 10, "head": "pool3",
             "n_batches": 4, "batch_size": 4, "n_points_per_layer": 10,
             "problem_seed": 0},
    "tres": {"name": "tres", "program_model": "tiny_resnet", "reference": "resnet50",
             "image_size": 32, "stem_width": 8,
             "stages": [[2, 2, 8, 16], [3, 2, 12, 24]], "num_classes": 10,
             "bn_eps": 1e-9, "head": "pool5",
             "n_batches": 4, "batch_size": 4, "n_points_per_layer": 10,
             "problem_seed": 0},
}
_SET = ["dic.rank_tol=0.1", "lasso.grid_size=32", "sample.seed=0",
        "solve.ls_ridge=0.0"]
TINY_TRAFFIC = {
    "tcp": {"mode": "prune", "channel_targets": {"conv1_1": 5, "conv1_2": 6,
                                                 "conv2_1": 8, "conv2_2": 9,
                                                 "conv3_1": 10},
            "input_targets": None,
            "set": ["solve.band=bottom", "solve.dtype=bfloat16", *_SET],
            "control_rounding": "fp8"},
    "trcp": {"mode": "prune",
             "channel_targets": {"res2a_branch2a": 6, "res2b_branch2b": 5,
                                 "res3a_branch2b": 8},
             "input_targets": {"res2b_branch2a": 12},
             "set": ["solve.band=bottom", "solve.dtype=float32", *_SET],
             "control_rounding": "tf32"},
}
# limits of the tiny cells, from their CPU readings (problems 0-3): the
# program's refit excess 3e-4 to 6e-4 (tcp) and 3e-12 to 3e-11 (trcp), the
# controls' 6e-3 to 1e-2 and 5e-8 to 8e-8 (problems 0-2); the freezes 0
# against 3e-3 to 6e-3; the selections 0 on every problem, the controls' 0
# to 0.17 (tcp) and 0 (trcp), a selection by weight norm 0.375 to 0.6
TINY_LIMITS = {
    "tvgg.tcp": {"freeze_gap": 1e-4, "counts_off": 0, "select_off": 0.1,
                 "refit_excess": 2e-3},
    "tres.trcp": {"freeze_gap": 1e-4, "counts_off": 0, "select_off": 0.1,
                  "refit_excess": 1e-8},
}


def write_root(root: Path, extra_cells: dict | None = None) -> Path:
    """A checkout root holding BENCHMARK.json and the tiny cells' data."""
    base = root / "port_bench"
    for sub in ("configs", "traffic", "limits"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    for n, c in TINY_CONFIGS.items():
        (base / "configs" / f"{n}.json").write_text(json.dumps(c))
    for n, t in TINY_TRAFFIC.items():
        (base / "traffic" / f"{n}.json").write_text(json.dumps(t))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": n, "source": "tiny", "reduced": [], "why": "test",
                         "file": f"port_bench/configs/{n}.json"}
                        for n in TINY_CONFIGS]
    cells = {"tvgg.tcp": ("tvgg", "tcp"), "tres.trcp": ("tres", "trcp"),
             **(extra_cells or {})}
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                           "why": "test"} for n, (c, t) in cells.items()]
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for n, lim in TINY_LIMITS.items():
        (base / "limits" / f"{n}.json").write_text(json.dumps(lim))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_root(tmp_path)
