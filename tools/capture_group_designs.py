"""Capture the group-lasso designs of a whole-model prune with
`dic.grplasso=true`: for every 1x1 consumer, the rows its group search
solved, the search's arguments and the card's answer.

    python3 tools/capture_group_designs.py [--out STEM] [--cache-from DIR]

runs `cli prune --model resnet50 --mode prune --speed 2.0 --set
dic.grplasso=true --device cuda` (the CLI's defaults: 50 x 10 synthetic
images at 224², `solve.band=bottom` for the released table, f32 replays)
and writes `STEM.npz` (per layer `X::<layer>` (rows, c) and `Y::<layer>`
(rows, n), f32, exactly as `ops/lasso.search_alpha_group` received them)
and `STEM.json` (the card, the CLI arguments, per layer its kind, (c, n),
the search's arguments, the card's mask, alpha and count, the K3 grids it
solved with their sweeps and ms, and the search's seconds). The default
STEM is `work/resnet50_2x_grplasso_designs`. `--cache-from DIR` solves a
copy of DIR's frozen cache instead of freezing anew.

`tools/jax_reference.py --group-designs STEM.npz` then gives the JAX
package's answer on the same rows, on the CPU.

The hook (`Recorder`) wraps module attributes for the length of one run:
`lasso.group_gram` (the subsampled rows), `lasso.search_alpha_group` (the
arguments and the answer), `group_cd.group_cd_solve_grid` (each grid's
per-alpha sweeps and CUDA-event time: K3 writes its stats beside B, no
launch is added) and `prune.select_and_reconstruct` (one call a solved
layer, in the order of the CLI's layer reports, with the K1 / K2 / K3
launches inside it). Imports torch and the port only.
"""
from __future__ import annotations

import argparse
import json
import platform
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from channel_pruning_tpu_torch import reference as ref  # noqa: E402

CLI_ARGS = ["prune", "--model", "resnet50", "--mode", "prune", "--speed", "2.0",
            "--set", "dic.grplasso=true"]
STEM = ROOT / "work" / "resnet50_2x_grplasso_designs"


class Recorder:
    """Record every group search of the runs made inside `with Recorder()
    as rec:`. `rec.calls` holds one dict a solved layer, in solve order:
    launches {"k1", "k2", "k3"} inside it, `grids` of the fused K1 search
    (None elsewhere) and, for a group search, `design`: X and Y (numpy),
    `args`, the answer (`mask`, `alpha`, `count`), `seconds` and `grids`, a
    list of (c, n, stats (A, 2) numpy, ms) per K3 grid."""

    def __init__(self):
        self.calls: list[dict] = []
        self._rows = None
        self._grids = None

    def __enter__(self):
        import torch

        from channel_pruning_tpu_torch.kernels import group_cd, lasso_cd
        from channel_pruning_tpu_torch.ops import lasso
        from channel_pruning_tpu_torch.pipeline import prune

        gram0, search0 = lasso.group_gram, lasso.search_alpha_group
        grid0, layer0 = group_cd.group_cd_solve_grid, prune.select_and_reconstruct
        self._saved = (lasso, prune, group_cd, gram0, search0, grid0, layer0)

        def launches():
            return {"k1": lasso_cd.LAUNCHES, "k2": lasso_cd.LAUNCHES_STREAM,
                    "k3": group_cd.LAUNCHES}

        def sync(t):
            if t.is_cuda:
                torch.cuda.synchronize(t.device)

        def group_gram(X, Y):
            self._rows = (X.detach().cpu().numpy().copy(),
                          Y.detach().cpu().numpy().copy())
            return gram0(X, Y)

        def search_alpha_group(gram, rank, rank_tol, alpha0=1e-3, grid_size=16,
                               max_rounds=8, n_sweeps=200, prefer="top"):
            X, Y = self._rows
            self._rows, self._grids = None, []
            sync(gram.G)
            t = time.perf_counter()
            mask, alpha, count = search0(
                gram, rank, rank_tol, alpha0=alpha0, grid_size=grid_size,
                max_rounds=max_rounds, n_sweeps=n_sweeps, prefer=prefer)
            sync(gram.G)
            seconds = time.perf_counter() - t
            grids = [(c, n, st.cpu().numpy(),
                      t0.elapsed_time(t1) if t0 is not None else ms)
                     for c, n, st, t0, t1, ms in self._grids]
            self._grids = None
            self.calls[-1]["design"] = {
                "X": X, "Y": Y,
                "args": {"rank": int(rank), "rank_tol": float(rank_tol),
                         "prefer": prefer, "alpha0": float(alpha0),
                         "grid_size": int(grid_size),
                         "max_rounds": int(max_rounds),
                         "n_sweeps": int(n_sweeps)},
                "mask": np.asarray(mask, bool), "alpha": float(alpha),
                "count": int(count), "seconds": seconds, "grids": grids}
            return mask, alpha, count

        def group_cd_solve_grid(G, C, alphas_n, n_sweeps=200, tol=1e-8,
                                stats=None):
            if self._grids is None or stats is not None:
                return grid0(G, C, alphas_n, n_sweeps=n_sweeps, tol=tol,
                             stats=stats)
            stats = torch.zeros((alphas_n.shape[0], 2), dtype=torch.int32,
                                device=G.device)
            t0 = t1 = None
            if G.is_cuda:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
            t = time.perf_counter()
            B = grid0(G, C, alphas_n, n_sweeps=n_sweeps, tol=tol, stats=stats)
            if t1 is not None:
                t1.record()
            self._grids.append((int(C.shape[0]), int(C.shape[1]), stats, t0,
                                t1, 1e3 * (time.perf_counter() - t)))
            return B

        def select_and_reconstruct(*a, **kw):
            before = launches()
            call = {"design": None}
            self.calls.append(call)
            res = layer0(*a, **kw)
            after = launches()
            call["launches"] = {k: after[k] - before[k] for k in after}
            call["grids"] = res.grids
            return res

        lasso.group_gram, lasso.search_alpha_group = group_gram, search_alpha_group
        group_cd.group_cd_solve_grid = group_cd_solve_grid
        prune.select_and_reconstruct = select_and_reconstruct
        return self

    def __exit__(self, *exc):
        lasso, prune, group_cd, gram0, search0, grid0, layer0 = self._saved
        lasso.group_gram, lasso.search_alpha_group = gram0, search0
        group_cd.group_cd_solve_grid = grid0
        prune.select_and_reconstruct = layer0
        return False

    def layers(self, reports) -> list[tuple]:
        """(report, call) a solved layer, the calls matched to the CLI's
        layer reports in solve order."""
        if len(reports) != len(self.calls):
            raise AssertionError(f"{len(self.calls)} layer solves recorded, "
                                 f"{len(reports)} layers reported")
        for r, call in zip(reports, self.calls):
            d = call["design"]
            if d is not None and d["X"].shape[1] != r.total:
                raise AssertionError(f"{r.conv}: a design of {d['X'].shape[1]} "
                                     f"channels, the layer has {r.total}")
        return list(zip(reports, self.calls))


def card_line() -> str:
    """nvidia-smi's name and power limit, or the CPU where there is no card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except OSError:
        pass
    return f"no card ({platform.machine()} CPU)"


def design_record(r, call) -> dict:
    """The JSON record of one group search (no arrays but the mask)."""
    d = call["design"]
    sweeps = np.concatenate([g[2][:, 0] for g in d["grids"]]) \
        if d["grids"] else np.zeros(1, np.int32)
    return {
        "kind": r.kind, "c": int(d["X"].shape[1]), "n": int(d["Y"].shape[1]),
        "rows": int(d["X"].shape[0]),
        "sha256": {"X": ref.sha256_array(d["X"]), "Y": ref.sha256_array(d["Y"])},
        "args": d["args"],
        "card": {"mask": ref.pack_selections({"m": d["mask"]})["m"],
                 "alpha": d["alpha"], "count": d["count"],
                 "seconds": d["seconds"], "grids": len(d["grids"]),
                 "grid_ms": [g[3] for g in d["grids"]],
                 "sweeps": [int(sweeps.min()), int(np.median(sweeps)),
                            int(sweeps.max())]},
        "rmse": [float(r.rmse_before), float(r.rmse_after)],
    }


def write(stem: Path, rec: Recorder, res, argv: list[str], wall: float,
          card: str) -> dict:
    """STEM.npz (every design's rows) and STEM.json (provenance and per
    design its arguments and the card's answer); returns the JSON."""
    from channel_pruning_tpu_torch.utils.config import default_config

    cfg = default_config()
    stem.parent.mkdir(parents=True, exist_ok=True)
    arrays, designs = {}, {}
    for r, call in rec.layers(res.reports):
        if call["design"] is None:
            continue
        arrays[f"X::{r.conv}"] = call["design"]["X"]
        arrays[f"Y::{r.conv}"] = call["design"]["Y"]
        designs[r.conv] = design_record(r, call)
    meta = {
        "path": "resnet50_2x_grplasso",
        "provenance": {
            "card": card, "captured_utc": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "capture_tool": "tools/capture_group_designs.py",
            "cli": [str(Path(a).relative_to(ROOT)) if a.startswith(f"{ROOT}/")
                    else a for a in argv],
            "calibration": "the CLI's synthetic set, seed 0",
            "row_seed": cfg.sample.seed, "rows": "min(lasso.subsample_rows "
            f"= {cfg.lasso.subsample_rows}, N // 20) of the layer's N",
            "wall_s": wall, "cli_wall": res.wall,
        },
        "designs": designs,
    }
    np.savez(stem.with_suffix(".npz"), **arrays)
    stem.with_suffix(".json").write_text(json.dumps(meta, indent=1) + "\n")
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(STEM), help="artifact stem")
    ap.add_argument("--work", default=str(ROOT / "work" / "group_designs"),
                    help="the CLI's work dir")
    ap.add_argument("--cache-from", default=None,
                    help="a work dir whose frozen cache the run solves")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("cli", nargs="*",
                    help="CLI arguments replacing the default ResNet-50 2x "
                         "grplasso prune (after --)")
    a = ap.parse_args(argv)
    from channel_pruning_tpu_torch import cli

    work = Path(a.work)
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    if a.cache_from:
        for f in Path(a.cache_from).glob("frozen_*.npz"):
            shutil.copy(f, work / f.name)
    args = [*(a.cli or CLI_ARGS), "--device", a.device, "--work-dir", str(work)]
    t = time.perf_counter()
    with Recorder() as rec:
        res = cli.main(args)
    wall = time.perf_counter() - t
    meta = write(Path(a.out), rec, res, args, wall, card_line())
    for name, d in meta["designs"].items():
        cd = d["card"]
        print(f"[capture] {name:<16s} {d['kind']:<5s} (c, n) = ({d['c']}, "
              f"{d['n']}) keep {cd['count']}/{d['c']} (target "
              f"{d['args']['rank']}) alpha {cd['alpha']:.6g}; {cd['grids']} "
              f"grids, sweeps {cd['sweeps'][0]}/{cd['sweeps'][1]}/"
              f"{cd['sweeps'][2]}, {cd['seconds']:.2f}s")
    print(f"[capture] {len(meta['designs'])} designs -> {a.out}.(npz|json); "
          f"wall {wall:.1f}s on {meta['provenance']['card']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
