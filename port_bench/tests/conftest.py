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
    "txc": {"name": "txc", "program_model": "tiny_xception", "reference": "xception",
            "image_size": 64, "stem_widths": [8, 8], "entry_widths": [16, 32, 91],
            "middle_blocks": 2, "exit_widths": [91, 128, 192, 256],
            "num_classes": 10, "bn_eps": 1e-9, "head": "global_pool",
            "n_batches": 16, "batch_size": 4, "n_points_per_layer": 10,
            "problem_seed": 0},
}
# c3.plan_uniform_targets(<the preprocessed tiny_xception>, 2.0): keep
# fraction 0.533, a target for every conv
TXC_TARGETS = {
    "conv1": 4, "conv2": 4, "entry1_shortcut": 9, "entry1_sep1_dw": 4,
    "entry1_sep1_pw": 9, "entry1_sep2_dw": 9, "entry1_sep2_pw": 9,
    "entry2_shortcut": 17, "entry2_sep1_dw": 9, "entry2_sep1_pw": 17,
    "entry2_sep2_dw": 17, "entry2_sep2_pw": 17, "entry3_shortcut": 48,
    "entry3_sep1_dw": 17, "entry3_sep1_pw": 48, "entry3_sep2_dw": 48,
    "entry3_sep2_pw": 48,
    **{f"mid{i}_sep{j}_{k}": 48 for i in (1, 2) for j in (1, 2, 3)
       for k in ("dw", "pw")},
    "exit_shortcut": 68, "exit_sep1_dw": 48, "exit_sep1_pw": 48,
    "exit_sep2_dw": 48, "exit_sep2_pw": 68, "exit_sep3_dw": 68,
    "exit_sep3_pw": 102, "exit_sep4_dw": 102, "exit_sep4_pw": 136}
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
    # 50 sweeps an alpha, not 200: on the CPU every live grid of this net
    # runs all its sweeps (a job 63 s at 200, 12-14 s at 50), and the
    # selections still equal the exact LASSO's on problems 0-3
    "txcp": {"mode": "prune", "channel_targets": TXC_TARGETS, "input_targets": None,
             "set": ["solve.band=bottom", "solve.dtype=float32",
                     "lasso.n_sweeps=50", *_SET],
             "control_rounding": "tf32"},
}
# the same without exit_sep4_pw's target: the gate in front of exit_sep3_dw
# is the last layer the job solves
TINY_TRAFFIC["txcp3"] = {**TINY_TRAFFIC["txcp"], "channel_targets": {
    k: v for k, v in TXC_TARGETS.items() if k != "exit_sep4_dw"}}
# limits of the tiny cells, from their CPU readings (problems 0-3): the
# program's refit excess 3e-4 to 6e-4 (tcp) and 3e-12 to 3e-11 (trcp), the
# controls' 6e-3 to 1e-2 and 5e-8 to 8e-8 (problems 0-2); the freezes 0
# against 3e-3 to 6e-3; the selections 0 on every problem, the controls' 0
# to 0.17 (tcp) and 0 (trcp), a selection by weight norm 0.375 to 0.6.
# txc (64², 64 images: the exit flow's 2 x 2 maps give the 102-112 kept
# inputs of exit_sep4_pw ~256 distinct rows; at 32² and 32 images the sound
# refit excess read 3.5e-7, the control's 5.7e-7): the program's refit excess
# 1.5e-9 to 8.6e-9, the TF32 control's 2.3e-7 to 3.2e-7 (problems 0-2); the
# freezes 8.0e-7 to 1.2e-6 (the fc) against 1.0e-2 to 2.1e-2; the selections
# 0, the control's 0; depthwise_off 1.9e-9 to 2.2e-9 (the f32 fold of
# BatchNorm), a depthwise conv on other channels inf
TINY_LIMITS = {
    "tvgg.tcp": {"freeze_gap": 1e-4, "counts_off": 0, "select_off": 0.1,
                 "refit_excess": 2e-3},
    "tres.trcp": {"freeze_gap": 1e-4, "counts_off": 0, "select_off": 0.1,
                  "refit_excess": 1e-8},
    "txc.txcp": {"freeze_gap": 1e-4, "counts_off": 0, "select_off": 0.1,
                 "refit_excess": 5e-8, "depthwise_off": 1e-6},
}
TINY_LIMITS["txc.txcp3"] = TINY_LIMITS["txc.txcp"]


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
             "txc.txcp": ("txc", "txcp"), "txc.txcp3": ("txc", "txcp3"),
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
