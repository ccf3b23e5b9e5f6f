"""Write the JAX package's own answer for one full-size path, for the
PyTorch/CUDA port to be held to (`channel_pruning_tpu_torch.reference`):

    JAX_PLATFORMS=cpu python tools/jax_reference.py --path vgg16_5x

The run is the JAX package's `cli prune` with the defaults of that path
(the VGG preset of bf16 replays included), on the CPU, with two changes:
`cli._calibration` hands the CLI a seeded numpy array of images
(`reference.images`, the same bytes on every machine) in place of its
threefry synthetic set, and the solve stays on one device (as the port's
CLI on one card) where the host platform has several. The freeze, the solve and the export are the
CLI's own code. Written next to the port's reference module,
`channel_pruning_tpu_torch/reference/data/<path>.(json|npz)`:

  * provenance: the commit, the seeds, the shapes, the config as the CLI
    built it (captured at its call of c3.solve_prune / c3.solve_3c), the
    channel targets or ranks, the sha256 of the images, of the weights
    (sorted by name) and of the point plan, the CPU wall of the run;
  * the freeze digest: per frozen tensor, the mean and RMS of each channel
    over the frozen rows, in f64 (.npz);
  * per solved layer, in solve order: name, rank, kept / total, rMSE
    before and after; the kept masks by consumer; the conv mults before
    and after.

The provenance also records the spec's `--set` options (the paths other
than the released tables' run at `solve.band=bottom`) and any cut of the
calibration set below the CLI's 50 x 10 default (`reduced`).

This tool is the one place that imports the JAX package beside the port.
Paths: vgg16_5x, resnet50_2x, vgg16_3c_4x, frcnn_600_5x, xception_2x
(reference.PATHS).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from channel_pruning_tpu_torch import reference as ref  # noqa: E402


def _commit() -> dict:
    def git(*a):
        try:
            return subprocess.run(["git", *a], cwd=ROOT, capture_output=True,
                                  text=True, timeout=30).stdout.strip()
        except OSError:
            return ""
    return {"commit": git("rev-parse", "HEAD"),
            "jax_package_dirty": bool(git("status", "--porcelain", "--",
                                          "channel_pruning_tpu"))}


def reduced(spec: dict) -> list[str]:
    """The spec's cuts of the CLI's default calibration set, if any."""
    n, b = spec["cal_batches"], spec["cal_batch"]
    if (n, b) == (ref.CAL_BATCHES, ref.CAL_BATCH):
        return []
    return [f"calibration set {n} x {b} images, of the CLI's default "
            f"{ref.CAL_BATCHES} x {ref.CAL_BATCH}"]


def produce(path: str, spec: dict, work: Path, out_stem: Path) -> dict:
    """Run the JAX CLI's prune of `spec` in `work` and write the artifact to
    `out_stem`.(json|npz); returns its metadata."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from channel_pruning_tpu import cli
    from channel_pruning_tpu.pipeline import c3
    from channel_pruning_tpu.utils import flops

    seen: dict = {}
    load_model, calibration, solver_mesh = (cli._load_model, cli._calibration,
                                            cli._solver_mesh)
    solvers = {"solve_prune": c3.solve_prune, "solve_3c": c3.solve_3c}

    def _load(args):
        g, p = load_model(args)
        seen["params"] = p
        return g, p

    def _calibrate(args, graph):
        shape = (args.cal_batches, args.cal_batch, *graph.inputs[0].shape[1:])
        seen["images"] = ref.images(shape, spec["image_seed"])
        return seen["images"], None

    def _capture(name):
        def solve(graph, params, cache, cfg, *a, **kw):
            seen.update(graph=graph, cache=cache, cfg=cfg, solver=name,
                        solve_args=a, solve_kw={k: v for k, v in kw.items()
                                                if k in ("channel_targets",
                                                         "input_targets")})
            return solvers[name](graph, params, cache, cfg, *a, **kw)
        return solve

    work.mkdir(parents=True, exist_ok=True)
    for f in work.glob("frozen_*.npz"):
        f.unlink()                     # always the CLI's own freeze
    # one device, as the port's CLI on one card: a host platform split into
    # several devices would shard the solve's sums in another order
    cli._load_model, cli._calibration = _load, _calibrate
    cli._solver_mesh = lambda: None
    c3.solve_prune, c3.solve_3c = _capture("solve_prune"), _capture("solve_3c")
    try:
        t0 = time.perf_counter()
        res = cli.main([*ref.cli_args(spec), "--platform", "cpu",
                        "--work-dir", str(work)])
        wall = time.perf_counter() - t0
    finally:
        cli._load_model, cli._calibration = load_model, calibration
        cli._solver_mesh = solver_mesh
        c3.solve_prune, c3.solve_3c = solvers["solve_prune"], solvers["solve_3c"]

    cache, cfg = seen["cache"], seen["cfg"]
    targets = {k: v for k, v in seen["solve_kw"].items() if v is not None}
    if seen["solver"] == "solve_3c":
        targets["ranks"] = seen["solve_args"][0]
    meta = {
        "path": path,
        "spec": spec,
        "provenance": {
            **_commit(), "jax": jax.__version__, "python": platform.python_version(),
            "cpu": platform.machine(), "cpu_count": os.cpu_count(),
            "cpu_wall_s": wall, "tool": "tools/jax_reference.py",
            "set": list(spec.get("set", [])), "reduced": reduced(spec),
        },
        "config": json.loads(json.dumps(dataclasses.asdict(cfg), default=str)),
        "targets": json.loads(json.dumps(targets, default=int)),
        "shapes": {"images": list(seen["images"].shape)},
        "sha256": {"images": ref.sha256_array(seen["images"]),
                   "weights": ref.weights_sha(seen["params"]),
                   "plan": ref.plan_sha(cache.plan)},
        "freeze": {"tensors": list(cache.plan),
                   "n_points": int(cfg.sample.n_points_per_layer),
                   "seed": int(cfg.sample.seed),
                   "rows": {t: int(f.shape[0]) for t, f in cache.feats.items()}},
        "layers": ref.report_rows(res.reports),
        "selections": ref.pack_selections(res.selections),
        "conv_mults": {
            "before": int(flops.total_flops(seen["graph"], include_fc=False)),
            "after": int(flops.total_flops(res.graph, include_fc=False))},
    }
    ref.save(out_stem, meta, ref.digest(cache.feats))
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", required=True, choices=sorted(ref.PATHS))
    ap.add_argument("--work", default=None,
                    help="the CLI's work dir (default work/jax_reference/<path>)")
    ap.add_argument("--out", default=None,
                    help="artifact stem (default the port's reference/data/<path>)")
    a = ap.parse_args(argv)
    work = Path(a.work or ROOT / "work" / "jax_reference" / a.path)
    out = Path(a.out or ref.DATA / a.path)
    meta = produce(a.path, ref.spec_for(a.path), work, out)
    kept = " ".join(f"{r['kept']}" for r in meta["layers"])
    print(f"[jax_reference] {a.path}: {len(meta['layers'])} layers, keep {kept}; "
          f"conv mults {meta['conv_mults']['before']:,} -> "
          f"{meta['conv_mults']['after']:,}; CPU wall "
          f"{meta['provenance']['cpu_wall_s']:.1f}s -> {out}.(json|npz)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
