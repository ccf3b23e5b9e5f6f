"""Capture the designs of a whole-model prune on the card: for every
search of one kind, what it solved, its arguments and the card's answer.

Group lasso (the default kind):

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

Single-task LASSO (`--path`, or `--kind lasso` with CLI arguments after
`--`):

    python3 tools/capture_group_designs.py --path xception_2x [--out STEM]

runs `cli prune` of a path of `channel_pruning_tpu_torch.reference.PATHS`
(vgg16_3c_4x, frcnn_600_5x, xception_2x: the numpy images of
`reference.calibration_images`, He-init weights of seed 0,
`solve.band=bottom`) and records every single-task search: its Gram form
G (c, c), whole, and b (c,) as `ops/lasso._fused_search` (or the
host-stepped `search_alpha`) received them, `n_samples`, the arguments,
and the card's mask, alpha, support and grids. It then re-solves every
recorded G and b on the same device and raises unless each answer equals
the run's bit for bit (mask, alpha, support). `STEM.npz` (`G::<layer>`,
`b::<layer>`) and `STEM.json` keep the first layer of each (c, n, kh·kw)
class with c <= `--max-c` (512) and the layers `--layers` names (by
default the path's `NAMED`: where the two packages' whole-path
masks parted); every
other searched layer is listed under the provenance's `left_out` with its
(c, n). The default STEM is `work/<path>_designs`.

`tools/jax_reference.py --group-designs STEM.npz` / `--lasso-designs
STEM.npz` then gives the JAX package's answer on the same inputs, on the
CPU.

The hook (`Recorder`) wraps module attributes for the length of one run:
`lasso.group_gram` (the subsampled rows), `lasso.search_alpha_group` (the
arguments and the answer), `group_cd.group_cd_solve_grid` (each grid's
per-alpha sweeps and CUDA-event time: K3 writes its stats beside B, no
launch is added), `lasso._fused_search` and `lasso.search_alpha` (copies
of G and b on their device, the arguments, the answer; no host read
inside the run), `prune.select_and_reconstruct` and `prune.
_fused_layer_solve` (one call a solved layer, in the order of the CLI's
layer reports, with the K1 / K2 / K3 launches inside it) and
`c3._pipelined_conv_pass` (a pass that restarts on the sequential path
drops its calls). Imports torch and the port only.
"""
from __future__ import annotations

import argparse
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
# per path, the layers kept beside the first of each class: where the two
# packages' whole-path runs kept masks past the bar (3C's two arms farthest
# apart; the RPN conv and heads; Xception's first parting and two farther)
NAMED = {"vgg16_3c_4x": ("conv4_2", "conv4_3"),
         "frcnn_600_5x": ("rpn_conv/3x3", "rpn_cls_score", "rpn_bbox_pred"),
         "xception_2x": ("mid1_sep3_pw", "mid3_sep1_pw", "mid6_sep1_pw")}
MAX_C = 512


def _w2_shape(a, kw, key) -> tuple:
    """(n, c, kh, kw) of a layer solve's consumer weight (its second
    argument)."""
    w = a[1] if len(a) > 1 else kw[key]
    return tuple(int(d) for d in w.shape)


class Recorder:
    """Record every search of the runs made inside `with Recorder() as
    rec:`. `rec.calls` holds one dict a solved layer, in solve order:
    launches {"k1", "k2", "k3"} inside it, `w2` the consumer weight's
    (n, c, kh, kw), `grids` of the fused K1 search (None elsewhere); for a
    group search `design`: X and Y (numpy), `args`, the answer (`mask`,
    `alpha`, `count`), `seconds` and `grids`, a list of (c, n, stats (A, 2)
    numpy, ms) per K3 grid; for a single-task search `lasso`: `search`
    ("fused" or "host"), G and b (numpy, whole), `n_samples`, `args` and
    the answer (`mask`, `alpha`, `count`, `grids`; the fused search's read
    on the host when the block ends). A layer that searched twice (an
    empty fused selection falls through to the generic path) keeps the
    last search, whose answer the layer used."""

    def __init__(self):
        self.calls: list[dict] = []
        self._rows = None
        self._grids = None
        self._depth = 0

    def _layer(self, w2) -> dict:
        """The open layer's call, or a new one when none is open."""
        if self._depth == 0 or not self.calls:
            self.calls.append({"design": None, "lasso": None, "w2": w2,
                               "grids": None, "launches": None})
        return self.calls[-1]

    def __enter__(self):
        import torch

        from channel_pruning_tpu_torch.kernels import group_cd, lasso_cd
        from channel_pruning_tpu_torch.ops import lasso
        from channel_pruning_tpu_torch.pipeline import c3, prune

        saved = ((lasso, "group_gram"), (lasso, "search_alpha_group"),
                 (lasso, "_fused_search"), (lasso, "search_alpha"),
                 (group_cd, "group_cd_solve_grid"),
                 (prune, "select_and_reconstruct"),
                 (prune, "_fused_layer_solve"), (c3, "_pipelined_conv_pass"))
        self._saved = [(m, name, getattr(m, name)) for m, name in saved]
        gram0, search0 = lasso.group_gram, lasso.search_alpha_group
        fused0, host0 = lasso._fused_search, lasso.search_alpha
        grid0, layer0 = group_cd.group_cd_solve_grid, prune.select_and_reconstruct
        solve0, pass0 = prune._fused_layer_solve, c3._pipelined_conv_pass

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

        def record_lasso(search, G, b, n_samples, args, answer):
            # device copies, read on the host when the block ends: a host
            # read here would sync inside the pipelined pass's dispatch
            self._layer(None)["lasso"] = {
                "search": search, "G": G.detach().clone(),
                "b": b.detach().clone(), "n_samples": int(n_samples),
                "args": {"rank": int(args[0]), "rank_tol": float(args[1]),
                         "alpha0": float(args[2]), "grid_size": int(args[3]),
                         "max_rounds": int(args[4]), "n_sweeps": int(args[5]),
                         "prefer": args[6]},
                "answer": answer}

        def _fused_search(G, b, n_samples, rank, rank_tol, alpha0, grid_size,
                          max_rounds, n_sweeps, prefer):
            out = fused0(G, b, n_samples, rank, rank_tol, alpha0, grid_size,
                         max_rounds, n_sweeps, prefer)
            record_lasso("fused", G, b, n_samples,
                         (rank, rank_tol, alpha0, grid_size, max_rounds,
                          n_sweeps, prefer), out)
            return out

        def search_alpha(gram, rank, rank_tol, alpha0=1e-3, grid_size=16,
                         max_rounds=8, n_sweeps=200, prefer="top"):
            out = host0(gram, rank, rank_tol, alpha0=alpha0,
                        grid_size=grid_size, max_rounds=max_rounds,
                        n_sweeps=n_sweeps, prefer=prefer)
            record_lasso("host", gram.G, gram.b, gram.n_samples,
                         (rank, rank_tol, alpha0, grid_size, max_rounds,
                          n_sweeps, prefer), out)
            return out

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

        def layer_call(fn, a, kw, key, grids):
            """One solved layer's call around fn(*a, **kw)."""
            before = launches()
            call = self._layer(_w2_shape(a, kw, key))
            self._depth += 1
            try:
                res = fn(*a, **kw)
            finally:
                self._depth -= 1
            after = launches()
            call["launches"] = {k: after[k] - before[k] for k in after}
            call["grids"] = grids(res)
            return res

        def select_and_reconstruct(*a, **kw):
            return layer_call(layer0, a, kw, "W2", lambda res: res.grids)

        def _fused_layer_solve(*a, **kw):
            if self._depth:             # inside select_and_reconstruct
                return solve0(*a, **kw)
            return layer_call(solve0, a, kw, "W2d", lambda out: out.grids)

        def _pipelined_conv_pass(*a, **kw):
            n = len(self.calls)
            try:
                return pass0(*a, **kw)
            except Exception:
                del self.calls[n:]      # restarted on the sequential path
                raise

        lasso.group_gram, lasso.search_alpha_group = group_gram, search_alpha_group
        lasso._fused_search, lasso.search_alpha = _fused_search, search_alpha
        group_cd.group_cd_solve_grid = group_cd_solve_grid
        prune.select_and_reconstruct = select_and_reconstruct
        prune._fused_layer_solve = _fused_layer_solve
        c3._pipelined_conv_pass = _pipelined_conv_pass
        return self

    def __exit__(self, exc_type, *exc):
        for m, name, fn in self._saved:
            setattr(m, name, fn)
        if exc_type is not None:
            return False
        for call in self.calls:
            if call["grids"] is not None:
                call["grids"] = int(call["grids"])
            d = call["lasso"]
            if d is None:
                continue
            ans = d.pop("answer")
            if d["search"] == "fused":
                d.update(mask=ans.mask.cpu().numpy(), alpha=float(ans.alpha),
                         count=int(ans.support), grids=int(ans.grids))
            else:
                d.update(mask=np.asarray(ans[0], bool), alpha=float(ans[1]),
                         count=int(ans[2]), grids=None)
            d["G"], d["b"] = d["G"].cpu().numpy(), d["b"].cpu().numpy()
        return False

    def layers(self, reports) -> list[tuple]:
        """(report, call) a solved layer (a report with a kept count: a 3C
        decomposition's own report has none), the calls matched to the
        CLI's layer reports in solve order."""
        solved = [r for r in reports if r.kept is not None]
        if len(solved) != len(self.calls):
            raise AssertionError(f"{len(self.calls)} layer solves recorded, "
                                 f"{len(solved)} layers reported")
        for r, call in zip(solved, self.calls):
            d, s = call["design"], call["lasso"]
            c = d["X"].shape[1] if d is not None else \
                s["G"].shape[0] if s is not None else r.total
            if c != r.total or (call["w2"] and call["w2"][1] != r.total):
                raise AssertionError(f"{r.conv}: a design of {c} channels, "
                                     f"the layer has {r.total}")
        return list(zip(solved, self.calls))


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


def lasso_design_record(r, call, seconds: float) -> dict:
    """The JSON record of one single-task search (no arrays but the mask);
    `seconds` the device re-solve's."""
    d = call["lasso"]
    n, c, kh, kw = call["w2"]
    return {
        "kind": r.kind, "c": int(c), "n": int(n), "khkw": int(kh * kw),
        "n_samples": d["n_samples"], "search": d["search"],
        "sha256": {"G": ref.sha256_array(d["G"]), "b": ref.sha256_array(d["b"])},
        "args": d["args"],
        "card": {"mask": ref.pack_selections({"m": d["mask"]})["m"],
                 "alpha": d["alpha"], "count": d["count"], "grids": d["grids"],
                 "seconds": seconds},
        "rmse": [float(r.rmse_before), float(r.rmse_after)],
    }


def provenance(argv: list[str], res, wall: float, card: str) -> dict:
    from channel_pruning_tpu_torch.utils.config import default_config

    cfg = default_config()
    return {
        "card": card, "captured_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                                    time.gmtime()),
        "capture_tool": "tools/capture_group_designs.py",
        "cli": [str(Path(a).relative_to(ROOT)) if a.startswith(f"{ROOT}/")
                else a for a in argv],
        "row_seed": cfg.sample.seed, "rows": "min(lasso.subsample_rows "
        f"= {cfg.lasso.subsample_rows}, N // 20) of the layer's N",
        "wall_s": wall, "cli_wall": res.wall,
    }


def write(stem: Path, rec: Recorder, res, argv: list[str], wall: float,
          card: str) -> dict:
    """STEM.npz (every group design's rows) and STEM.json (provenance and
    per design its arguments and the card's answer); returns the JSON."""
    arrays, designs = {}, {}
    for r, call in rec.layers(res.reports):
        if call["design"] is None:
            continue
        arrays[f"X::{r.conv}"] = call["design"]["X"]
        arrays[f"Y::{r.conv}"] = call["design"]["Y"]
        designs[r.conv] = design_record(r, call)
    meta = {"path": "resnet50_2x_grplasso",
            "provenance": {**provenance(argv, res, wall, card),
                           "calibration": "the CLI's synthetic set, seed 0"},
            "designs": designs}
    ref.save_designs(stem, meta, arrays)
    return meta


def chosen(layers, max_c: int, named) -> tuple[list[str], dict]:
    """(the layers kept: the first of each (c, n, kh·kw) class with c <=
    max_c, and every named one; {left-out layer: [c, n]})."""
    keep, classes, left = [], set(), {}
    for r, call in layers:
        if call["lasso"] is None:
            continue
        n, c, kh, kw = call["w2"]
        cls = (c, n, kh * kw)
        if r.conv in named or (c <= max_c and cls not in classes):
            keep.append(r.conv)
            classes.add(cls)
        else:
            left[r.conv] = [c, n]
    missing = set(named) - set(keep)
    if missing:
        raise AssertionError(f"named layers with no single-task search: "
                             f"{sorted(missing)}")
    return keep, left


def write_lasso(stem: Path, path: str, rec: Recorder, res, argv: list[str],
                wall: float, card: str, device, max_c: int, named,
                extra: dict) -> dict:
    """Re-solve every recorded single-task search on `device` (each answer
    must equal the run's bit for bit, else AssertionError), then write
    STEM.npz (`G::<layer>`, `b::<layer>` of the chosen layers) and
    STEM.json; returns the JSON."""
    import torch

    layers = rec.layers(res.reports)
    keep, left = chosen(layers, max_c, named)
    arrays, designs, unequal = {}, {}, []
    for r, call in layers:
        d = call["lasso"]
        if d is None:
            continue
        probe = ref.LassoDesign(r.conv, d["G"], d["b"], {
            "n_samples": d["n_samples"], "search": d["search"],
            "args": d["args"]})
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        mask, alpha, count = ref.solve_lasso(probe, device)
        seconds = time.perf_counter() - t
        if not (np.array_equal(mask, d["mask"]) and alpha == d["alpha"]
                and count == d["count"]):
            unequal.append(f"{r.conv}: keep {count} alpha {alpha!r} on the "
                           f"re-solve, {d['count']} alpha {d['alpha']!r} in "
                           f"the run, {int((mask != d['mask']).sum())} "
                           "channels differ")
        if r.conv in keep:
            arrays[f"G::{r.conv}"], arrays[f"b::{r.conv}"] = d["G"], d["b"]
            designs[r.conv] = lasso_design_record(r, call, seconds)
    if unequal:
        raise AssertionError("the re-solve differs from the run: "
                             + "; ".join(unequal))
    meta = {"path": path,
            "provenance": {**provenance(argv, res, wall, card), **extra,
                           "self_check": "every recorded search re-solved "
                           "on the device: mask, alpha and support equal "
                           "bit for bit", "max_c": max_c,
                           "named": list(named), "left_out": left},
            "designs": designs}
    ref.save_designs(stem, meta, arrays)
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=sorted(NAMED), default=None,
                    help="capture the single-task LASSO designs of this "
                         "reference path")
    ap.add_argument("--kind", choices=("group", "lasso"), default=None,
                    help="the searches to capture (default lasso with "
                         "--path, else group)")
    ap.add_argument("--out", default=None, help="artifact stem")
    ap.add_argument("--work", default=str(ROOT / "work" / "group_designs"),
                    help="the CLI's work dir")
    ap.add_argument("--cache-from", default=None,
                    help="a work dir whose frozen cache the run solves")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-c", type=int, default=MAX_C,
                    help="LASSO: keep the first layer of each class up to "
                         "this width")
    ap.add_argument("--layers", default=None,
                    help="LASSO: comma-separated layers kept besides (default "
                         "the path's NAMED)")
    ap.add_argument("cli", nargs="*",
                    help="CLI arguments replacing the default ResNet-50 2x "
                         "grplasso prune (after --)")
    a = ap.parse_args(argv)
    from channel_pruning_tpu_torch import cli

    kind = a.kind or ("lasso" if a.path else "group")
    work = Path(a.work)
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    if a.cache_from:
        for f in Path(a.cache_from).glob("frozen_*.npz"):
            shutil.copy(f, work / f.name)
    extra, cal = {}, None
    if a.path:
        spec = ref.spec_for(a.path)
        cal = ref.calibration_images(spec)
        base = ref.cli_args(spec)
        extra = {"spec": spec, "images_sha256": ref.sha256_array(cal),
                 "calibration": f"reference.images, seed {spec['image_seed']}; "
                 f"He-init weights, seed {spec['weight_seed']}"}
    else:
        base = a.cli or CLI_ARGS
    args = [*base, "--device", a.device, "--work-dir", str(work)]
    t = time.perf_counter()
    with Recorder() as rec:
        res = cli.main(args, cal_inputs=cal)
    wall = time.perf_counter() - t
    if kind == "group":
        out = Path(a.out or STEM)
        meta = write(out, rec, res, args, wall, card_line())
        for name, d in meta["designs"].items():
            cd = d["card"]
            print(f"[capture] {name:<16s} {d['kind']:<5s} (c, n) = ({d['c']}, "
                  f"{d['n']}) keep {cd['count']}/{d['c']} (target "
                  f"{d['args']['rank']}) alpha {cd['alpha']:.6g}; {cd['grids']} "
                  f"grids, sweeps {cd['sweeps'][0]}/{cd['sweeps'][1]}/"
                  f"{cd['sweeps'][2]}, {cd['seconds']:.2f}s")
    else:
        path = a.path or "cli"
        out = Path(a.out or ROOT / "work" / ref.lasso_designs_stem(path))
        named = a.layers.split(",") if a.layers else NAMED.get(a.path, ())
        meta = write_lasso(out, path, rec, res, args, wall, card_line(),
                           a.device, a.max_c, named, extra)
        for name, d in meta["designs"].items():
            cd = d["card"]
            print(f"[capture] {name:<16s} {d['kind']:<5s} (c, n, kh·kw) = "
                  f"({d['c']}, {d['n']}, {d['khkw']}) keep {cd['count']}/"
                  f"{d['c']} (target {d['args']['rank']}) alpha "
                  f"{cd['alpha']:.6g}; {d['search']} search, {cd['grids']} "
                  f"grids; re-solve {cd['seconds']:.3f}s, bit for bit")
        print("[capture] left out: " + ", ".join(
            f"{k} {v}" for k, v in meta["provenance"]["left_out"].items()))
    print(f"[capture] {len(meta['designs'])} designs -> {out}.(npz|json); "
          f"wall {wall:.1f}s on {meta['provenance']['card']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
