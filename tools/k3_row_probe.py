#!/usr/bin/env python3
"""Where a row step of the group-lasso kernel K3 goes, on one NVIDIA card:

    python3 tools/k3_row_probe.py [c,n ...]      (default: 256,256)

Builds a copy of channel_pruning_tpu_torch/csrc/group_cd.cu with clock64
probes (into channel_pruning_tpu_torch/_build/), runs it on chip_smoke's
seeded 16-alpha problem of each shape over 5 sweeps, and prints, for the
blocks of the first alpha's cluster (the densest alpha), the cycles of
thread 0 from the moment a row's delta has arrived (its mbarrier wait
returns) to: the relaxed cluster arrive, the next row's staging and block
barrier (owner of the next row), the row's squares summed in its warp, the
solve's block barrier, the norm and scale, the pushes, the moved count's
barrier, the update of the block's other rows and the row's cluster wait;
medians over rows 64-71 of the third sweep, and the row-to-row period.
The probes are stores to shared memory, read out after the last sweep: a
probe that stored to device memory would make a release wait on it.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

POINTS = ["arrived", "arrive", "staged", "warp sum", "sum barrier",
          "scale", "pushed", "moved barrier", "other rows", "cluster wait"]

# (text of group_cd.cu, the text that replaces it)
PROBES = [
    ("constexpr int kStaticBudget = 512;", "constexpr int kStaticBudget = 2048;"),
    ("namespace {\n", """namespace {
__device__ long long g_probe[16][8][10];
#define PROBE(p) do { if (probing && pj >= 64 && pj < 72) { long long v_; \\
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(v_) :: "memory"); \\
  s_probe[pj - 64][p] = v_; } } while (0)
"""),
    ("  __shared__ int s_moves;\n",
     "  __shared__ int s_moves;\n  __shared__ long long s_probe[8][10];\n"
     "  bool probing = false;\n  int pj = -1;\n"),
    ("  int moves = 0;\n", "  int moves = 0;\n  int it = 0;\n"),
    ("  int it = 0;\n  while (true) {", "  while (true) {"),
    ("      mbar_wait(smem_u32(&s_full[s]), (R >> 1) & 1);\n",
     "      mbar_wait(smem_u32(&s_full[s]), (R >> 1) & 1);\n"
     "      probing = blockIdx.x < K && t == 0 && it == 2; pj = j;\n"
     "      PROBE(0);\n"),
    ("      if (early) cluster_arrive_relaxed();\n",
     "      if (early) cluster_arrive_relaxed();\n      PROBE(1);\n"),
    ("        __syncthreads();\n        solve_row(next, R + 1);\n",
     "        __syncthreads();\n        PROBE(2);\n"
     "        solve_row(next, R + 1);\n"),
    ("    ss = warp_sum(ss);\n", "    ss = warp_sum(ss);\n    consume(ss); PROBE(3);\n"),
    ("    ss = warp_sum(s_red[lane]);", "    PROBE(4);\n    ss = warp_sum(s_red[lane]);"),
    ("        fmaxf(0.0f, __fsub_rn(1.0f, __fdiv_rn(alpha_n, norm))), sdj);\n",
     "        fmaxf(0.0f, __fsub_rn(1.0f, __fdiv_rn(alpha_n, norm))), sdj);\n"
     "    consume(scale); PROBE(5);\n"),
    ("    // off the critical path: the pushes are on their way\n",
     "    PROBE(6);\n"),
    ("    moves += __syncthreads_or(moved) != 0 && t == 0;\n",
     "    moves += __syncthreads_or(moved) != 0 && t == 0;\n    PROBE(7);\n"),
    ("      update_all(my_lo, my_hi, skip);\n",
     "      update_all(my_lo, my_hi, skip);\n      __syncwarp();\n      PROBE(8);\n"),
    ("      cluster_wait();\n", "      cluster_wait();\n      PROBE(9);\n"),
    ("  if (t == 0) s_moves = moves;\n",
     "  if (t == 0) s_moves = moves;\n  if (blockIdx.x < K && t < 80) "
     "g_probe[rank][t / 10][t % 10] = s_probe[t / 10][t % 10];\n"),
    ("extern \"C\" {\n",
     "extern \"C\" {\n\nint cp_probe_read(long long* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n}\n"),
]


def probe_source(text: str) -> str:
    """group_cd.cu with the probes; raises if a piece of it has moved."""
    for old, new in PROBES:
        if old not in text:
            raise RuntimeError(f"not found in group_cd.cu: {old!r}")
        text = text.replace(old, new, 1)
    return text


def main() -> int:
    import torch

    import chip_smoke
    from channel_pruning_tpu_torch.kernels import group_cd, lasso_cd

    if not torch.cuda.is_available():
        print("k3_row_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    lasso_cd.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = lasso_cd.BUILD_DIR / "k3_row_probe.cu"
    src.write_text(probe_source(group_cd.SOURCE.read_text()))
    lib = lasso_cd.compile_source(src)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cp_group_cd_grid.argtypes = [ptr] * 6 + [i32] * 4 + [
        ctypes.c_float, i32, i32, i32, ptr]
    lib.cp_group_cd_grid.restype = ctypes.c_int
    lib.cp_group_cd_max_active_clusters.argtypes = [i32, i32, i32, ptr]
    lib.cp_group_cd_error_string.argtypes = [ctypes.c_int]
    lib.cp_group_cd_error_string.restype = ctypes.c_char_p
    lib.cp_probe_read.argtypes = [ptr]
    group_cd._lib, group_cd._ACTIVE = lib, {}
    print(chip_smoke._card_line())
    dev = torch.device("cuda")
    for shape in sys.argv[1:] or ["256,256"]:
        c, n = map(int, shape.split(","))
        gram, alphas = chip_smoke._group_problem(0, c, n, dev)
        plan = group_cd.launch_plan(c, n, chip_smoke.A_GRID, dev)
        ms, _ = chip_smoke._time_ms(lambda: group_cd.group_cd_solve_grid(
            gram.G, gram.C, alphas, n_sweeps=5), 1)
        buf = np.zeros((16, 8, 10), np.int64)
        lib.cp_probe_read(buf.ctypes.data)
        print(f"(c, n) = ({c}, {n}): variant {plan.variant}, K={plan.k}; "
              f"5 sweeps {ms:.3f} ms (probed build)")
        for r in range(plan.k):
            rows = buf[r]
            period = np.diff(rows[:, 0])
            # a block that solved one of rows 65-72 stored its solve points
            solved = [i for i in range(8) if (64 + i + 1) % plan.k == r]
            parts = []
            for p, name in enumerate(POINTS):
                idx = solved if 2 <= p <= 7 else range(8)
                if p == 0 or not idx:
                    continue
                vals = [rows[i, p] - rows[i, 0] for i in idx]
                parts.append(f"{name} {int(np.median(vals))}")
            print(f"  block {r} (solves {[64 + i + 1 for i in solved]}): "
                  f"cycles after the delta arrived: {', '.join(parts)}; "
                  f"row-to-row median {int(np.median(period))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
