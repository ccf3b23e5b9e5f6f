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

The group lasso is answered on captured designs instead of a whole path:

    JAX_PLATFORMS=cpu python tools/jax_reference.py \
        --group-designs work/resnet50_2x_grplasso_designs.npz \
        --layers res2a_branch2a,res2a_branch2c [--out STEM]

reads the rows and arguments `tools/capture_group_designs.py` recorded on
the card, runs the JAX package's `group_gram` and `search_alpha_group` on
each named design (all by default) on one CPU device, and adds the rows,
the card's record and the JAX answer (mask, alpha, count, seconds) to
`STEM.(npz|json)` (default the port's
reference/data/resnet50_2x_grplasso_designs), after each design; an
existing STEM is extended. The provenance lists the captured designs that
are left out, by (c, n).

The single-task LASSO searches of VGG-16 3C 4x, Faster-RCNN 600² 5x and
Xception 2x are answered the same way:

    JAX_PLATFORMS=cpu python tools/jax_reference.py \
        --lasso-designs work/xception_2x_designs.npz [--out STEM]

reads the G and b `tools/capture_group_designs.py --path` recorded on the
card and runs the JAX package's `fused_search_alpha` (`search_alpha` for a
host-stepped capture) on each on one CPU device; default STEM the port's
reference/data/<path>_designs. The capture's own `left_out` is carried
over.
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


def _jax_group(arrays: dict, rec: dict):
    """The JAX package's group search on a group design's rows."""
    import jax.numpy as jnp

    from channel_pruning_tpu.ops import lasso as jlasso

    gram = jlasso.group_gram(jnp.asarray(arrays["X"]), jnp.asarray(arrays["Y"]))
    return jlasso.search_alpha_group(gram, **rec["args"])


def _jax_lasso(arrays: dict, rec: dict):
    """The JAX package's single-task search on a LASSO design's G and b:
    `fused_search_alpha` (the one-program `_fused_search`) or, for a
    host-stepped capture, `search_alpha`."""
    import jax.numpy as jnp

    from channel_pruning_tpu.ops import lasso as jlasso

    gram = jlasso.LassoGram(jnp.asarray(arrays["G"]), jnp.asarray(arrays["b"]),
                            rec["n_samples"])
    search = jlasso.search_alpha if rec["search"] == "host" \
        else jlasso.fused_search_alpha
    return search(gram, **rec["args"])


KINDS = {"group": (ref.GroupDesign, _jax_group),
         "lasso": (ref.LassoDesign, _jax_lasso)}


def answer_designs(src: Path, layers: list[str] | None, out: Path,
                   notes: dict, kind: str = "group") -> dict:
    """The JAX package's search on each captured design of `src` named in
    `layers` (all by default), written into `out` after each (an existing
    `out` is extended); `kind` "group" (`--group-designs`) or "lasso"
    (`--lasso-designs`). Returns the metadata."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    design_cls, solve = KINDS[kind]
    src = Path(src).with_suffix("")
    captured = json.loads(src.with_suffix(".json").read_text())
    names = layers or list(captured["designs"])
    arrays: dict = {}
    if out.with_suffix(".json").exists():
        meta, have = ref.load_designs(out, design_cls)
        for name, d in have.items():
            for key in design_cls.ARRAYS:
                arrays[f"{key}::{name}"] = getattr(d, key)
    else:
        meta = {"path": captured["path"],
                "provenance": dict(captured["provenance"]), "designs": {}}
    meta["provenance"]["jax_answer"] = {
        **_commit(), "jax": jax.__version__, "python": platform.python_version(),
        "cpu": platform.machine(), "cpu_count": os.cpu_count(),
        "devices": 1, "tool": f"tools/jax_reference.py --{kind}-designs",
        "notes": {**meta["provenance"].get("jax_answer", {}).get("notes", {}),
                  **notes}}
    left0 = captured["provenance"].get("left_out", {})
    with np.load(src.with_suffix(".npz")) as z:
        for name in names:
            rec = dict(captured["designs"][name])
            got = {key: z[f"{key}::{name}"] for key in design_cls.ARRAYS}
            t = time.perf_counter()
            mask, alpha, count = solve(got, rec)
            seconds = time.perf_counter() - t
            rec["jax"] = {"mask": ref.pack_selections({"m": mask})["m"],
                          "alpha": float(alpha), "count": int(count),
                          "seconds": seconds}
            meta["designs"][name] = rec
            for key, arr in got.items():
                arrays[f"{key}::{name}"] = arr
            order = [k for k in captured["designs"] if k in meta["designs"]]
            meta["designs"] = {k: meta["designs"][k] for k in order}
            meta["provenance"]["left_out"] = {**left0, **{
                k: [d["c"], d["n"]] for k, d in captured["designs"].items()
                if k not in meta["designs"]}}
            ref.save_designs(out, meta, arrays)
            card = rec["card"]
            gap = ref.compare_design(design_cls(name, *got.values(), rec),
                                     ref.unpack_mask(card["mask"]),
                                     card["alpha"], card["count"])
            print(f"[jax_reference] the card's answer against the JAX "
                  f"package's: {gap.line()}; JAX {seconds:.1f}s", flush=True)
    return meta


answer_group_designs = answer_designs      # its name before the LASSO kind


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=sorted(ref.PATHS))
    ap.add_argument("--group-designs", default=None,
                    help="a designs .npz of tools/capture_group_designs.py")
    ap.add_argument("--lasso-designs", default=None,
                    help="a LASSO designs .npz of tools/capture_group_designs.py "
                         "--path")
    ap.add_argument("--layers", default=None,
                    help="comma-separated designs to answer (default all)")
    ap.add_argument("--note", action="append", default=[],
                    help="KEY=VALUE added to the answer's provenance")
    ap.add_argument("--work", default=None,
                    help="the CLI's work dir (default work/jax_reference/<path>)")
    ap.add_argument("--out", default=None,
                    help="artifact stem (default the port's reference/data/<path>)")
    a = ap.parse_args(argv)
    if a.group_designs or a.lasso_designs:
        kind = "group" if a.group_designs else "lasso"
        src = Path(a.group_designs or a.lasso_designs)
        if kind == "group":
            out = Path(a.out or ref.DATA / ref.GROUP_DESIGNS)
        else:
            path = json.loads(src.with_suffix(".json").read_text())["path"]
            out = Path(a.out or ref.DATA / ref.lasso_designs_stem(path))
        notes = dict(kv.split("=", 1) for kv in a.note)
        answer_designs(src, a.layers.split(",") if a.layers else None, out,
                       notes, kind)
        return 0
    if not a.path:
        ap.error("--path, --group-designs or --lasso-designs is required")
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
