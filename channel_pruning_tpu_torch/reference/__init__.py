"""The JAX package's own answer at full size, and the check of the port
against it.

`tools/jax_reference.py` runs the JAX package's `cli prune` on the CPU on
a seeded numpy calibration set (the same array on every machine, bit for
bit) and the numpy He-init weights, and writes what it found under
`data/<path>.json` (provenance, per pruned layer the kept count, the kept
mask and the rMSE before and after, the conv mults) and `data/<path>.npz`
(per frozen tensor, the mean and RMS of each channel over the frozen rows,
in f64). This module regenerates those inputs (their sha256 checked
against the artifact), digests the port's frozen cache the same way and
holds the port's result to the artifact (`compare`).

The bars of `compare` (a fault raises `ReferenceFault`):
  * every kept count (and every 3C rank) equal;
  * freeze fidelity: each channel's mean and RMS within 1e-4 of the
    tensor's RMS of the JAX value (an f32 conv on the card against XLA's
    on the CPU);
  * per layer, at most max(2, 1% of its input channels) channels kept by
    one package and not by the other (a swap of one kept channel for
    another counts one);
  * every rMSE after within 1e-2 of the JAX value, relative.
Every gap is measured and printed, not only the faults.

The paths without a released table (VGG-16 3C 4x, Faster-RCNN 600² 5x,
Xception 2x) run at `solve.band=bottom`, as the released tables do. At the
CLI's default top of the band the support search takes the largest count
in [t, 1.1 t] whose LASSO support it reaches, and that count moves with
f32 summation order: the JAX package split over 8 host devices keeps 14 of
VGG-16 3C's 23 counts of its own one-device run. The bottom of the band
lands on the target itself, so the bars above hold unchanged. Xception's
calibration set is cut to 20 x 10 images (2,000 rows a layer), so that the
JAX package's CPU run ends in hours; image size, width and depth are the
published ones on every path.

The group lasso (`dic.grplasso=true`) is held on its designs instead of a
whole path: `tools/capture_group_designs.py` records on the card, for every
1x1 consumer of ResNet-50 2x, the rows its group search solved (250 of
them, `ops/lasso.row_subsample`) and the search's arguments;
`tools/jax_reference.py --group-designs` solves the same rows with the
JAX package's `group_gram` and `search_alpha_group` on the CPU, and
`data/resnet50_2x_grplasso_designs.(npz|json)` keeps the rows of the
designs whose JAX solve fitted a CPU run, with both answers.
`load_group_designs` reads them (sha256 checked), `solve_group` runs the
port's search on one of them and `compare_group` holds its answer to the
JAX package's: the count equal and at most max(2, 1% of c) channels kept
by one package only (MASK_BAR); the alpha gap is measured, not held.

The single-task LASSO searches of the three paths whose whole-path masks
miss that bar (LASSO_DESIGN_PATHS) are held the same way: the capture tool
(`--path`) records each search's Gram form G and b on the card, whole and
as `_fused_search` received them, with its arguments and answer;
`tools/jax_reference.py --lasso-designs` runs the JAX package's
`fused_search_alpha` on the same G and b; `data/<path>_designs.(npz|json)`
keeps the first layer of each (c, n, kh·kw) class with c <= 512 and the
layers where the whole paths parted. `load_lasso_designs`, `solve_lasso`
and the shared `compare_design` read, re-solve and hold them.

Imports torch and the port; nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data"

IMAGE_SEED = 1       # the images' numpy seed (the weights' is 0)
WEIGHT_SEED = 0      # the CLI's init_params seed

# the committed paths: the CLI's arguments of each, at its defaults
PATHS = {
    "vgg16_5x": {"model": "vgg16", "mode": "prune", "speed": 5.0,
                 "image_size": 224},
    "resnet50_2x": {"model": "resnet50", "mode": "prune", "speed": 2.0,
                    "image_size": 224},
    "vgg16_3c_4x": {"model": "vgg16", "mode": "3c", "speed": 4.0,
                    "image_size": 224, "set": ["solve.band=bottom"]},
    "frcnn_600_5x": {"model": "frcnn_vgg16", "mode": "prune", "speed": 5.0,
                     "image_size": 600, "set": ["solve.band=bottom"]},
    "xception_2x": {"model": "xception", "mode": "prune", "speed": 2.0,
                    "image_size": 299, "set": ["solve.band=bottom"],
                    "cal_batches": 20},
}
CAL_BATCHES, CAL_BATCH = 50, 10      # the CLI's default calibration set

FREEZE_BAR = 1e-4        # of the tensor's RMS, per channel mean and RMS
MASK_BAR = (2, 0.01)     # max(2, 1% of the input channels)
RMSE_BAR = 1e-2          # relative, rMSE after


class ReferenceFault(AssertionError):
    """The port's result is outside a bar of `compare`."""


def spec_for(path: str, **over) -> dict:
    """The full spec of a committed path (or `over` on its own for a path
    that is not committed, e.g. a tiny model in a test): the CLI's
    arguments and the calibration set's shape and seed."""
    spec = {"model": "vgg16", "mode": "prune", "speed": 5.0,
            "image_size": None, "batch": CAL_BATCH,
            "cal_batches": CAL_BATCHES, "cal_batch": CAL_BATCH,
            "image_seed": IMAGE_SEED, "weight_seed": WEIGHT_SEED, "set": []}
    spec.update(PATHS.get(path, {}))
    spec.update(over)
    return spec


def cli_args(spec: dict) -> list[str]:
    """The `cli prune` arguments of a spec (both packages' CLIs)."""
    argv = ["prune", "--model", spec["model"], "--mode", spec["mode"],
            "--speed", str(spec["speed"]), "--batch", str(spec["batch"]),
            "--cal-batches", str(spec["cal_batches"]),
            "--cal-batch", str(spec["cal_batch"])]
    if spec.get("image_size"):
        argv += ["--image-size", str(spec["image_size"])]
    for kv in spec.get("set", []):
        argv += ["--set", kv]
    return argv


def images(shape, seed: int = IMAGE_SEED) -> np.ndarray:
    """The calibration set: unit normals from numpy's default generator.
    Drawn one batch at a time (the same stream as one draw of the whole
    shape), so no f64 copy of a 2 GB set is ever held."""
    shape = tuple(shape)
    rng = np.random.default_rng(seed)
    out = np.empty(shape, np.float32)
    for i in range(shape[0]):
        out[i] = rng.normal(size=shape[1:])
    return out


def sha256_array(a) -> str:
    a = np.ascontiguousarray(np.asarray(a))
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def weights_sha(params) -> str:
    """sha256 over every array of the parameters, sorted by layer and blob
    name."""
    h = hashlib.sha256()
    for layer in sorted(params):
        for blob in sorted(params[layer]):
            h.update(f"{layer}/{blob}".encode())
            h.update(sha256_array(params[layer][blob]).encode())
    return h.hexdigest()


def plan_sha(plan) -> str:
    """sha256 of a point plan {tensor: (ys, xs)}, sorted by tensor."""
    h = hashlib.sha256()
    for t in sorted(plan):
        ys, xs = plan[t]
        h.update(t.encode())
        h.update(sha256_array(ys).encode())
        h.update(sha256_array(xs).encode())
    return h.hexdigest()


def digest(feats) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """{tensor: (mean, rms)} of each channel over the frozen rows, in f64."""
    out = {}
    for t, f in feats.items():
        f = np.asarray(f, dtype=np.float64)
        f = f.reshape(f.shape[0], -1)
        out[t] = (f.mean(axis=0), np.sqrt((f * f).mean(axis=0)))
    return out


def freeze_digest(cache) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """`digest` of a frozen cache's sampled rows."""
    return digest(cache.feats)


def pack_selections(selections) -> dict:
    """{consumer: {"total": c, "kept": [indices]}} of boolean masks."""
    out = {}
    for k in sorted(selections):
        m = np.asarray(selections[k]).astype(bool).ravel()
        out[k] = {"total": int(m.size), "kept": np.flatnonzero(m).tolist()}
    return out


def unpack_mask(entry) -> np.ndarray:
    m = np.zeros(entry["total"], bool)
    m[entry["kept"]] = True
    return m


def report_rows(reports) -> list[dict]:
    """Each solved layer's name, rank, kept / total and rMSEs, in solve
    order (either package's LayerReport)."""
    return [{"conv": r.conv, "rank": None if r.rank is None else int(r.rank),
             "kept": None if r.kept is None else int(r.kept),
             "total": None if r.total is None else int(r.total),
             "rmse_before": float(r.rmse_before),
             "rmse_after": float(r.rmse_after)} for r in reports]


@dataclass
class Artifact:
    """A committed (or freshly written) JAX answer."""

    meta: dict
    digest: dict[str, tuple[np.ndarray, np.ndarray]]

    @property
    def spec(self) -> dict:
        return self.meta["spec"]

    @property
    def layers(self) -> list[dict]:
        return self.meta["layers"]

    @property
    def selections(self) -> dict:
        return self.meta["selections"]


def save(stem: Path, meta: dict, dig) -> None:
    stem = Path(stem)
    stem.parent.mkdir(parents=True, exist_ok=True)
    stem.with_suffix(".json").write_text(json.dumps(meta, indent=1) + "\n")
    payload = {}
    for t, (mean, rms) in dig.items():
        payload[f"mean::{t}"] = mean
        payload[f"rms::{t}"] = rms
    np.savez_compressed(stem.with_suffix(".npz"), **payload)


def load(path) -> Artifact:
    """A committed path by name (`vgg16_5x`) or an artifact's stem."""
    stem = DATA / path if isinstance(path, str) and "/" not in path else Path(path)
    stem = stem.with_suffix("")
    meta = json.loads(stem.with_suffix(".json").read_text())
    dig: dict = {}
    with np.load(stem.with_suffix(".npz")) as z:
        for k in z.files:
            kind, t = k.split("::", 1)
            dig.setdefault(t, [None, None])[kind == "rms"] = z[k]
    return Artifact(meta, {t: (m, r) for t, (m, r) in dig.items()})


def committed() -> list[str]:
    """The paths with an artifact under data/."""
    return [p for p in PATHS if (DATA / f"{p}.json").exists()]


@dataclass
class Inputs:
    params: dict             # the model's He-init weights (before preprocess)
    images: np.ndarray       # (cal_batches, cal_batch, C, H, W)
    plan: dict               # the freeze's point plan
    graph: object = None     # the graph after preprocess, as the CLI solves it


def calibration_images(spec: dict, graph=None) -> np.ndarray:
    """The spec's calibration set (`images` at its model's input shape), as
    both CLIs are handed it; `graph` the model, built from the spec if
    None."""
    if graph is None:
        from channel_pruning_tpu_torch.models import zoo

        kw = {"batch": spec["batch"]}
        if spec.get("image_size"):
            kw["image_size"] = spec["image_size"]
        graph = zoo.get_model(spec["model"], **kw)
    shape = (spec["cal_batches"], spec["cal_batch"], *graph.inputs[0].shape[1:])
    return images(shape, spec["image_seed"])


def regenerate(spec: dict, tensors, n_points: int, seed: int) -> Inputs:
    """The model, its weights, the images and the point plan of a spec,
    from numpy alone (the port's model zoo and sampler)."""
    from channel_pruning_tpu_torch.graph.ir import shapes_of
    from channel_pruning_tpu_torch.models import zoo
    from channel_pruning_tpu_torch.models.vgg import init_params
    from channel_pruning_tpu_torch.pipeline import c3
    from channel_pruning_tpu_torch.sampling.sampler import (make_point_plan,
                                                            resnet_share_key)

    kw = {"batch": spec["batch"]}
    if spec.get("image_size"):
        kw["image_size"] = spec["image_size"]
    g0 = zoo.get_model(spec["model"], **kw)
    params = init_params(g0, seed=spec["weight_seed"])
    graph, _ = c3.preprocess(g0, params)
    imgs = calibration_images(spec, graph)
    plan = make_point_plan(shapes_of(graph, batch=spec["cal_batch"]),
                           list(tensors), spec["cal_batches"], n_points, seed,
                           share_key=resnet_share_key(graph) if graph.sums else None)
    return Inputs(params, imgs, plan, graph)


def inputs(path) -> Inputs:
    """Regenerate a path's inputs from numpy and check the images', the
    weights' and the point plan's sha256 against its artifact."""
    art = path if isinstance(path, Artifact) else load(path)
    fz = art.meta["freeze"]
    got = regenerate(art.spec, fz["tensors"], fz["n_points"], fz["seed"])
    want = art.meta["sha256"]
    have = {"images": sha256_array(got.images), "weights": weights_sha(got.params),
            "plan": plan_sha(got.plan)}
    bad = [k for k in ("images", "weights", "plan") if have[k] != want[k]]
    if bad:
        raise ReferenceFault(f"{art.spec.get('path', path)}: regenerated "
                             f"{', '.join(bad)} sha256 differ from the artifact's")
    return got


@dataclass
class Report:
    """Every gap `compare` measured; `faults` is empty when within the bars."""

    path: str
    lines: list[str] = field(default_factory=list)
    faults: list[str] = field(default_factory=list)
    freeze_gap: float = 0.0
    freeze_gap_at: str = ""
    n_tensors: int = 0
    counts_equal: int = 0
    masks_equal: int = 0
    n_layers: int = 0
    n_masks: int = 0
    rmse_gap: float = 0.0
    rmse_gap_at: str = ""
    mask_gaps: dict = field(default_factory=dict)

    def summary(self) -> str:
        return (f"freeze max gap {self.freeze_gap:.1e} of RMS over "
                f"{self.n_tensors} tensors ({self.freeze_gap_at}); counts "
                f"{self.counts_equal}/{self.n_layers}; masks equal "
                f"{self.masks_equal}/{self.n_masks}; rMSE-after max rel gap "
                f"{self.rmse_gap:.1e} ({self.rmse_gap_at})")


def _sha_gaps(art: Artifact, cache, report: Report) -> None:
    want = art.meta["sha256"]
    if isinstance(cache.inputs, np.ndarray):
        if sha256_array(cache.inputs) != want["images"]:
            report.faults.append("images: sha256 differs from the artifact's")
    else:
        report.faults.append("images: the cache holds no host array")
    if plan_sha(cache.plan) != want["plan"]:
        report.faults.append("point plan: sha256 differs from the artifact's")


def _freeze_gaps(art: Artifact, cache, report: Report) -> None:
    mine = freeze_digest(cache)
    for t in sorted(art.digest):
        m_ref, r_ref = art.digest[t]
        if t not in mine:
            report.faults.append(f"freeze: tensor {t} was not frozen")
            continue
        m, r = mine[t]
        if m.shape != m_ref.shape:
            report.faults.append(f"freeze: tensor {t} has {m.size} channels, "
                                 f"want {m_ref.size}")
            continue
        scale = max(float(np.sqrt(np.mean(r_ref ** 2))), 1e-30)
        gap = float(max(np.abs(m - m_ref).max(), np.abs(r - r_ref).max())) / scale
        report.n_tensors += 1
        if gap > report.freeze_gap or not report.freeze_gap_at:
            report.freeze_gap, report.freeze_gap_at = gap, t
        if not gap <= FREEZE_BAR:
            report.faults.append(f"freeze: tensor {t} per-channel gap "
                                 f"{gap:.2e} of its RMS > {FREEZE_BAR:.0e}")


def compare(artifact, result, cache, raise_on_fault: bool = True) -> Report:
    """Hold the port's `result` (a SolveResult) and its frozen `cache` to an
    artifact. Raises ReferenceFault naming each layer or tensor outside a
    bar (unless `raise_on_fault` is False); returns the report of every gap
    either way."""
    art = artifact if isinstance(artifact, Artifact) else load(artifact)
    report = Report(art.meta.get("path", "?"))
    _sha_gaps(art, cache, report)
    _freeze_gaps(art, cache, report)

    mine = report_rows(result.reports)
    want = art.layers
    if [r["conv"] for r in mine] != [r["conv"] for r in want]:
        report.faults.append(f"layers: solved {[r['conv'] for r in mine]}, "
                             f"want {[r['conv'] for r in want]}")
    report.n_layers = len(want)
    for g, w in zip(mine, want):
        if g["conv"] != w["conv"]:
            continue
        # a 3C layer reports its decomposition (rank) and its arm (kept)
        name = w["conv"] + (f" rank {w['rank']}" if w["rank"] is not None else "")
        same = g["kept"] == w["kept"] and g["total"] == w["total"] \
            and g["rank"] == w["rank"]
        report.counts_equal += same
        if not same:
            report.faults.append(f"{name}: keep {g['kept']}/{g['total']} rank "
                                 f"{g['rank']}, want {w['kept']}/{w['total']} "
                                 f"rank {w['rank']}")
        rel = abs(g["rmse_after"] - w["rmse_after"]) / max(abs(w["rmse_after"]), 1e-30)
        if rel > report.rmse_gap or not report.rmse_gap_at:
            report.rmse_gap, report.rmse_gap_at = rel, name
        if not rel <= RMSE_BAR:
            report.faults.append(f"{name}: rMSE after {g['rmse_after']:.6g}, "
                                 f"want {w['rmse_after']:.6g} (rel gap "
                                 f"{rel:.2e} > {RMSE_BAR:.0e})")
        report.lines.append(
            f"{name:<18s} keep {g['kept']}/{g['total']} (jax {w['kept']}) "
            f"rMSE {g['rmse_before']:.5f} -> {g['rmse_after']:.5f} (jax "
            f"{w['rmse_before']:.5f} -> {w['rmse_after']:.5f}, rel gap {rel:.1e})")

    sel = result.selections
    report.n_masks = len(art.selections)
    for k, entry in art.selections.items():
        if k not in sel:
            report.faults.append(f"{k}: no selection")
            continue
        ref = unpack_mask(entry)
        got = np.asarray(sel[k]).astype(bool).ravel()
        if got.size != ref.size:
            report.faults.append(f"{k}: mask over {got.size} channels, want {ref.size}")
            continue
        diff = int(max((got & ~ref).sum(), (ref & ~got).sum()))
        report.mask_gaps[k] = diff
        report.masks_equal += diff == 0
        bar = max(MASK_BAR[0], int(MASK_BAR[1] * ref.size))
        if diff > bar:
            report.faults.append(f"{k}: {diff} channels kept by one package "
                                 f"only > {bar} of {ref.size}")
    gaps = ", ".join(f"{k} {v}" for k, v in report.mask_gaps.items() if v)
    report.lines.append("mask gaps (channels kept by one package only): "
                        + (gaps or "none"))
    if report.faults and raise_on_fault:
        raise ReferenceFault(f"{report.path}: " + "; ".join(report.faults)
                             + "\n" + "\n".join(report.lines))
    return report


GROUP_DESIGNS = "resnet50_2x_grplasso_designs"
# the paths whose single-task LASSO searches are held on committed designs
# (data/<path>_designs), their whole-path masks being past the bar
LASSO_DESIGN_PATHS = ("vgg16_3c_4x", "frcnn_600_5x", "xception_2x")


def lasso_designs_stem(path: str) -> str:
    return f"{path}_designs"


@dataclass
class GroupDesign:
    """One 1x1 consumer's group-lasso design: the rows X (rows, c) and Y
    (rows, n) its search solved, and its JSON record (`args` of the
    search, the card's answer `card` and the JAX package's `jax`)."""

    name: str
    X: np.ndarray
    Y: np.ndarray
    meta: dict
    ARRAYS = ("X", "Y")

    @property
    def args(self) -> dict:
        return self.meta["args"]

    @property
    def shape(self) -> tuple[int, int]:
        return self.X.shape[1], self.Y.shape[1]


@dataclass
class LassoDesign:
    """One layer's single-task LASSO search: its Gram form G (c, c), whole,
    and b (c,), f32 as the search received them, and its JSON record:
    `n_samples` (the rows of Z), `search` ("fused": `ops/lasso.
    _fused_search`; "host": the host-stepped `search_alpha`), `args`, the
    card's answer `card` and the JAX package's `jax`."""

    name: str
    G: np.ndarray
    b: np.ndarray
    meta: dict
    ARRAYS = ("G", "b")

    @property
    def args(self) -> dict:
        return self.meta["args"]

    @property
    def shape(self) -> tuple[int, int]:
        return self.meta["c"], self.meta["n"]


def save_designs(stem, meta: dict, arrays: dict) -> None:
    """`stem`.json (`meta`) and `stem`.npz (`<array>::<layer>`)."""
    stem = Path(stem)
    stem.parent.mkdir(parents=True, exist_ok=True)
    stem.with_suffix(".json").write_text(json.dumps(meta, indent=1) + "\n")
    np.savez_compressed(stem.with_suffix(".npz"), **arrays)


def load_designs(stem, kind=GroupDesign) -> tuple[dict, dict]:
    """(the JSON, {layer: `kind`}) of a designs artifact, by name under
    data/ or by stem; each design's arrays checked against the sha256 its
    record holds (ReferenceFault on a mismatch)."""
    stem = DATA / stem if isinstance(stem, str) and "/" not in stem else Path(stem)
    stem = stem.with_suffix("")
    meta = json.loads(stem.with_suffix(".json").read_text())
    out = {}
    with np.load(stem.with_suffix(".npz")) as z:
        for name, rec in meta["designs"].items():
            arrays = [z[f"{key}::{name}"] for key in kind.ARRAYS]
            for key, a in zip(kind.ARRAYS, arrays):
                if sha256_array(a) != rec["sha256"][key]:
                    raise ReferenceFault(f"{name}: {key}'s sha256 differs "
                                         "from its record")
            out[name] = kind(name, *arrays, rec)
    return meta, out


def load_group_designs(stem=GROUP_DESIGNS) -> tuple[dict, dict[str, GroupDesign]]:
    return load_designs(stem, GroupDesign)


def load_lasso_designs(path) -> tuple[dict, dict[str, LassoDesign]]:
    """A committed path's LASSO designs (`vgg16_3c_4x`) or a stem."""
    stem = lasso_designs_stem(path) if path in LASSO_DESIGN_PATHS else path
    return load_designs(stem, LassoDesign)


def solve_group(design: GroupDesign, device="cpu") -> tuple[np.ndarray, float, int]:
    """The port's answer on a design: `ops/lasso.group_gram` of its rows and
    `search_alpha_group` with its recorded arguments, on `device` (K3 on a
    card, its plain version on the CPU)."""
    import torch

    from channel_pruning_tpu_torch.ops import lasso

    X = torch.from_numpy(np.ascontiguousarray(design.X)).to(device)
    Y = torch.from_numpy(np.ascontiguousarray(design.Y)).to(device)
    return lasso.search_alpha_group(lasso.group_gram(X, Y), **design.args)


def solve_lasso(design: LassoDesign, device="cpu") -> tuple[np.ndarray, float, int]:
    """The port's answer on a design: its recorded search (`_fused_search`
    or `search_alpha`) on the stored G and b with its recorded arguments,
    on `device` (K1 / K2 on a card, their plain version on the CPU)."""
    import torch

    from channel_pruning_tpu_torch.ops import lasso

    G = torch.from_numpy(np.ascontiguousarray(design.G)).to(device)
    b = torch.from_numpy(np.ascontiguousarray(design.b)).to(device)
    n, a = design.meta["n_samples"], design.args
    if design.meta["search"] == "host":
        return lasso.search_alpha(lasso.LassoGram(G, b, n), **a)
    out = lasso._fused_search(G, b, n, a["rank"], a["rank_tol"], a["alpha0"],
                              a["grid_size"], a["max_rounds"], a["n_sweeps"],
                              a["prefer"])
    return out.mask.cpu().numpy(), float(out.alpha), int(out.support)


@dataclass
class DesignGap:
    """`compare_design`'s measure of one design; `faults` empty when within
    the bars."""

    name: str
    c: int
    n: int
    count: int
    want_count: int
    apart: int
    bar: int
    alpha: float
    want_alpha: float
    faults: list[str] = field(default_factory=list)

    @property
    def alpha_gap(self) -> float:
        return abs(self.alpha - self.want_alpha) / max(abs(self.want_alpha), 1e-30)

    def line(self) -> str:
        return (f"{self.name} (c, n) = ({self.c}, {self.n}): keep {self.count} "
                f"(jax {self.want_count}); {self.apart} channels kept by one "
                f"package only (bar {self.bar}); alpha {self.alpha:.6g} (jax "
                f"{self.want_alpha:.6g}, rel gap {self.alpha_gap:.1e})")


def compare_design(design, mask, alpha: float, count: int) -> DesignGap:
    """Hold an answer (mask, alpha, count) on a group or LASSO `design` to
    the JAX package's (the design's `jax` record): the count equal, at most
    max(2, 1% of c) channels kept by one package only. The alpha gap is
    measured only."""
    want = design.meta["jax"]
    ref = unpack_mask(want["mask"])
    got = np.asarray(mask).astype(bool).ravel()
    c, n = design.shape
    gap = DesignGap(design.name, c, n, int(count), int(want["count"]), 0,
                    max(MASK_BAR[0], int(MASK_BAR[1] * c)), float(alpha),
                    float(want["alpha"]))
    if got.size != ref.size:
        gap.faults.append(f"{design.name}: mask over {got.size} channels, "
                          f"want {ref.size}")
        return gap
    gap.apart = int(max((got & ~ref).sum(), (ref & ~got).sum()))
    if gap.count != gap.want_count or int(got.sum()) != gap.count:
        gap.faults.append(f"{design.name}: keep {gap.count} ({int(got.sum())} "
                          f"in the mask), want {gap.want_count}")
    if gap.apart > gap.bar:
        gap.faults.append(f"{design.name}: {gap.apart} channels kept by one "
                          f"package only > {gap.bar} of {c}")
    return gap


compare_group = compare_design      # the group kind's name since it came first
