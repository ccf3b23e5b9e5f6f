"""Command-line entry point (port of channel_pruning_tpu/cli.py).

    python -m channel_pruning_tpu_torch.cli prune --model vgg16 --speed 5.0
    python -m channel_pruning_tpu_torch.cli prune --model resnet50 --speed 2.0
    python -m channel_pruning_tpu_torch.cli prune --model vgg16 --mode 3c --speed 4.0
    python -m channel_pruning_tpu_torch.cli combine --prototxt work/3C_vgg16.prototxt \
        --weights work/3C_vgg16.caffemodel
    python -m channel_pruning_tpu_torch.cli flop --prototxt work/cb_vgg16.prototxt
    python -m channel_pruning_tpu_torch.cli finetune --prototxt work/cp_vgg16.prototxt \
        --weights work/cp_vgg16.caffemodel --data-dir <train> --steps 1000
    python -m channel_pruning_tpu_torch.cli eval --prototxt ... --data-dir <val>
    python -m channel_pruning_tpu_torch.cli time --prototxt work/cp_vgg16.prototxt \
        --per-layer --compare-prototxt <original.prototxt>
    python -m channel_pruning_tpu_torch.cli deploy --prototxt ... --weights ...
    python -m channel_pruning_tpu_torch.cli addbn --prototxt ... --weights ...

`prune` loads a registry model (random He-init weights, or `--weights`
through the Caffe codec, io/caffe.py), freezes a calibration set (synthetic,
or `--data-dir`: an imagefolder or a Caffe LMDB, with its labels), and
solves it: `--mode prune` prunes every layer with LASSO selection +
least-squares reconstruction; `--mode 3c` decomposes each conv spatially
(VH) and by channel (ITQ) and prunes the next conv's inputs; `--mode 2c`
decomposes only. It exports the result as prototxt + caffemodel (prefix
`cp_`, `3C_` or `2C_`) and the selections. `combine` merges each H conv
into its P conv (`cb_`); `flop` counts conv multiplies and parameters.
`finetune` trains with SGD/Nesterov (labels from `--data-dir`, synthetic
batches without it, or distillation against `--teacher-prototxt`) and
exports `ft_`; `eval` gives top-1/top-5 (or head fidelity against a
teacher); `time` gives forward latency, throughput and MFU, per layer with
`--per-layer`; `deploy` exports a `torch.export` archive (`.pt2`); `addbn`
measures per-channel statistics and inserts BatchNorm + Scale after every
conv (`bn_`); `splitrelu` makes in-place ReLUs addressable (`s_`);
`verify-release` runs the released-model acceptance protocol. Every
subcommand that touches a device takes `--device`, which defaults to
`cuda` and never falls back to the CPU.

The defaults are the JAX CLI's: the channel-pruning solve is the pipelined
pass with the fused alpha search (`--set solve.fused_search=False` runs the
sequential host-stepped solve), and every graph whose name contains "vgg"
replays in bf16 (`solve.dtype=bfloat16`: operands rounded to bf16, f32
products, sums and outputs) unless `--set solve.dtype=...` is given;
`--set solve.dtype=float32` replays in f32.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def _load_model(args):
    from channel_pruning_tpu_torch.io import caffe as cio
    from channel_pruning_tpu_torch.models import zoo
    from channel_pruning_tpu_torch.models.vgg import init_params

    if args.prototxt:
        g, params = cio.import_model(args.prototxt, args.weights,
                                     batch=args.batch)
        return g, params or init_params(g, seed=0)
    kw = {"batch": args.batch}
    if args.image_size:
        kw["image_size"] = args.image_size
    g = zoo.get_model(args.model or "vgg16", **kw)
    params = init_params(g, seed=0)
    if args.weights:
        g, loaded = cio.load_weights(g, args.weights)
        params.update(loaded)
    return g, params


def _resize_dim(crop: int) -> int:
    """Shorter-side resize target for a crop, keeping the reference's
    256/224 ratio at any input size."""
    return max(crop + 1, int(round(crop * 256 / 224)))


def _image_batches(args, graph, mean=None, **kw):
    """Batches from an imagefolder or a Caffe LMDB (a directory holding
    data.mdb), cropped to the model's input, with `mean` (a BGR pixel or an
    (H, W, C) image; the BGR pixel mean without) subtracted and then
    multiplied by `--input-scale`. Imagefolders of up to 20,000 images are
    decoded once and replayed from memory."""
    from channel_pruning_tpu_torch.data import pipeline as dp

    crop = graph.inputs[0].shape[2]
    batch = kw.pop("batch", args.batch)
    scale = float(args.input_scale or 1.0)
    if mean is not None:
        mean = np.asarray(mean, np.float32)

    def scaled(it):
        return it if scale == 1.0 else ((x * scale, y) for x, y in it)

    d = Path(args.data_dir)
    if d.name == "data.mdb" or (d / "data.mdb").exists():
        from channel_pruning_tpu_torch.data.lmdb import lmdb_batches
        if mean is not None and mean.ndim == 3:       # the Data layer's is CHW
            mean = np.ascontiguousarray(mean.transpose(2, 0, 1))
        return scaled(lmdb_batches(d, batch, new_dim=_resize_dim(crop),
                                   crop=crop, mean=mean, **kw))
    if len(dp._list_imagefolder(d)[0]) <= _PRELOAD_MAX_IMAGES:
        key = (str(d), crop, None if mean is None else mean.tobytes())
        if key not in _PRELOAD_CACHE:
            _PRELOAD_CACHE[key] = dp.preload_imagefolder(
                d, new_dim=_resize_dim(crop), crop=crop, mean=mean)
        kw.pop("random_crop", None)          # the preload is center crops
        return scaled(dp.memory_batches(*_PRELOAD_CACHE[key], batch, **kw))
    return scaled(dp.imagefolder_batches(d, batch, new_dim=_resize_dim(crop),
                                         crop=crop, mean=mean, **kw))


_PRELOAD_CACHE: dict = {}
_PRELOAD_MAX_IMAGES = 20_000


def _calibration(args, graph):
    """(inputs (n_batches, bs, C, H, W), labels or None): the host array a
    caller handed `main` (`cal_inputs`), shuffled batches of `--data-dir`
    with their labels, or a synthetic set that exists only as a seed."""
    from channel_pruning_tpu_torch.sampling.inputs import SyntheticInputs

    shape = graph.inputs[0].shape
    given = getattr(args, "cal_inputs", None)
    if given is not None:
        want = (args.cal_batches, args.cal_batch, *shape[1:])
        if tuple(given.shape) != want:
            raise ValueError(f"calibration array of shape {tuple(given.shape)}, "
                             f"want {want}")
        return np.asarray(given, np.float32), None
    if args.data_dir:
        from channel_pruning_tpu_torch.data.pipeline import calibration_batches
        src = _image_batches(args, graph, batch=args.cal_batch, shuffle=True,
                             seed=args.seed, loop=True)
        return calibration_batches(src, args.cal_batches, args.cal_batch,
                                   image=shape[2])
    return SyntheticInputs(n_batches=args.cal_batches, bs=args.cal_batch,
                           sample_shape=tuple(shape[1:]), seed=args.seed), None


def _build_config(args):
    from channel_pruning_tpu_torch.utils.config import default_config

    cfg = default_config()
    for kv in args.set or []:
        key, _, val = kv.partition("=")
        cfg = cfg.replace_nested(key, val)
    return cfg


def _targets(graph, args, cfg):
    """(producer-keyed channel targets, consumer-keyed gate targets or None,
    config)."""
    from channel_pruning_tpu_torch.models.resnet import resnet50_2x_targets
    from channel_pruning_tpu_torch.models.vgg import VGG16_5X_CHANNELS
    from channel_pruning_tpu_torch.pipeline import c3

    bottom = cfg.replace_nested("solve.band", "bottom")
    if args.channels:
        return json.loads(Path(args.channels).read_text()), None, bottom
    # released-structure tables: the channel counts are the ground truth,
    # so land on them instead of the top of the band
    if "vgg" in graph.name and len(graph.convs) == 13 \
            and abs(args.speed - 5.0) < 1e-6:
        return VGG16_5X_CHANNELS, None, bottom
    if "resnet50" in graph.name and abs(args.speed - 2.0) < 1e-6:
        return (*resnet50_2x_targets(), bottom)
    return c3.plan_uniform_targets(graph, args.speed,
                                   rank_tol=cfg.dic.rank_tol), None, cfg


def _ranks(graph, args) -> dict[str, int]:
    """3C/2C ranks: a json file, the VGG-16 4x table scaled to the speed,
    or num_output * 2 // speed for every conv after the first."""
    from channel_pruning_tpu_torch.models.vgg import VGG16_RANKS_4X
    from channel_pruning_tpu_torch.pipeline import c3

    if args.ranks:
        return json.loads(Path(args.ranks).read_text())
    if "vgg" in graph.name and len(graph.convs) == 13:
        return c3.ranks_for_speed(VGG16_RANKS_4X, args.speed)
    return {c: max(1, int(graph.layer(c).attr("num_output") * 2
                          // int(args.speed)))
            for c in graph.convs[1:]}


def _solver_mesh(device):
    """Every visible card when there is more than one (the JAX CLI's
    `_solver_mesh`): the freeze and the solve split images and solver rows
    over them. None on one card or the CPU."""
    import torch

    from channel_pruning_tpu_torch.parallel import mesh as mesh_mod

    if device.type == "cuda" and torch.cuda.device_count() > 1:
        mesh = mesh_mod.make_mesh()
        print(f"[prune] sharding solver reductions over {mesh.size} devices")
        return mesh
    return None


def cmd_prune(args):
    from channel_pruning_tpu_torch.io import caffe as cio
    from channel_pruning_tpu_torch.pipeline.checkpoint import SolveCheckpoint
    from channel_pruning_tpu_torch.utils import flops
    from channel_pruning_tpu_torch.convert import params_to_torch
    from channel_pruning_tpu_torch.device import resolve_device
    from channel_pruning_tpu_torch.pipeline import c3
    from channel_pruning_tpu_torch.sampling.sampler import (
        FrozenCache, freeze, freeze_tensor_set, params_for_tensors,
        resnet_share_key)

    device = resolve_device(args.device)
    cfg = _build_config(args)
    wd = _workdir(args)
    phases: dict[str, float] = {}
    t0 = time.perf_counter()
    graph, params = _load_model(args)
    phases["load"] = time.perf_counter() - t0
    if ("vgg" in graph.name
            and not any(kv.startswith("solve.dtype") for kv in args.set or [])):
        # the JAX CLI's VGG preset (channel_pruning_tpu/cli.py:161-165);
        # other families stay on f32
        cfg = cfg.replace_nested("solve.dtype", "bfloat16")
    print(f"[prune] model {graph.name}: {len(graph.convs)} convs, "
          f"{flops.total_flops(graph):,} mults; device {_card(device)}; "
          f"replays in {cfg.solve.dtype}")

    graph, params = c3.preprocess(graph, params)
    mesh = _solver_mesh(device)    # once: the freeze and the solve share it
    if mesh is not None:
        device = mesh.lead
    if args.mode == "prune":
        targets, input_targets, cfg = _targets(graph, args, cfg)
    else:
        ranks = _ranks(graph, args)
        if args.mode == "2c":
            cfg = cfg.replace_nested("dic.vh", False)   # decomposition only
    c3.check_supported(graph, cfg)          # before the freeze, not after
    inputs, labels = _calibration(args, graph)
    cache_path = wd / f"frozen_{inputs.shape[0]}x{inputs.shape[1]}.npz"
    t = time.perf_counter()
    if cache_path.exists() and not args.refreeze:
        print(f"[prune] loading frozen cache {cache_path}")
        cache = FrozenCache.load(cache_path)
    else:
        fc_bytes = sum(int(np.asarray(v).nbytes)
                       for f in graph.fcs for v in params.get(f, {}).values())
        tensors = freeze_tensor_set(
            graph, include_fc=cfg.dic.fitfc or fc_bytes < (64 << 20))
        dparams = params_to_torch(params_for_tensors(graph, params, tensors),
                                  device)
        cache = freeze(graph, dparams, inputs, device=device, tensors=tensors,
                       n_points=cfg.sample.n_points_per_layer,
                       seed=cfg.sample.seed,
                       share_key=resnet_share_key(graph) if graph.sums else None,
                       labels=labels,
                       chunk_batches=max(cfg.sample.freeze_device_batch
                                         // inputs.shape[1], 1), mesh=mesh)
        del dparams
        cache.save(cache_path)
        print(f"[prune] froze calibration cache -> {cache_path}")
    phases["freeze"] = time.perf_counter() - t

    t = time.perf_counter()
    if args.mode == "prune":
        ck = SolveCheckpoint(wd / "solve_state_cp.pkl", every=3)
        res = c3.solve_prune(graph, params, cache, cfg, channel_targets=targets,
                             input_targets=input_targets, device=device,
                             checkpoint=ck, mesh=mesh)
    else:
        ck = SolveCheckpoint(wd / "solve_state_3c.pkl", every=1)
        res = c3.solve_3c(graph, params, cache, cfg, ranks, device=device,
                          checkpoint=ck, mesh=mesh)
    phases["solve"] = time.perf_counter() - t
    print(res.summary())
    orig = flops.total_flops(graph, include_fc=False)
    new = flops.total_flops(res.graph, include_fc=False)
    print(f"[prune] conv mults {orig:,} -> {new:,} ({orig / max(new, 1):.2f}x)")

    t = time.perf_counter()
    prefix = {"3c": "3C", "2c": "2C", "prune": "cp"}[args.mode]
    stem = wd / f"{prefix}_{graph.name}"
    cio.export_model(res.graph, res.params, f"{stem}.prototxt",
                     f"{stem}.caffemodel")
    np.savez_compressed(f"{stem}_selections.npz", **res.selections)
    phases["export"] = time.perf_counter() - t
    print(f"[prune] artifacts -> {stem}.(prototxt|caffemodel)")
    print("[prune] wall " + " ".join(f"{k} {v:.2f}s" for k, v in phases.items())
          + f" total {time.perf_counter() - t0:.2f}s")
    res.wall = phases
    return res


def cmd_combine(args):
    """Merge each H conv into its P conv where that saves multiplies
    (reference combineHP), check on `--device` that the merged model
    computes the input model's output on one synthetic batch, and export
    `cb_<name>`. Returns the merged graph and parameters and the largest
    absolute difference of the two outputs."""
    from channel_pruning_tpu_torch.convert import params_to_torch
    from channel_pruning_tpu_torch.device import resolve_device
    from channel_pruning_tpu_torch.graph.rewrite import combine_hp
    from channel_pruning_tpu_torch.io import caffe as cio
    from channel_pruning_tpu_torch.ops.forward import run_graph
    from channel_pruning_tpu_torch.sampling.inputs import SyntheticInputs
    from channel_pruning_tpu_torch.utils import flops

    device = resolve_device(args.device)
    graph, params = _load_model(args)
    g2, p2 = combine_hp(graph, params)
    orig = flops.total_flops(graph, include_fc=False)
    new = flops.total_flops(g2, include_fc=False)
    print(f"[combine] conv mults {orig:,} -> {new:,} "
          f"({orig / max(new, 1):.2f}x fewer)")
    spec = graph.inputs[0]
    x = SyntheticInputs(1, spec.shape[0], tuple(spec.shape[1:]),
                        seed=0).batch(0).to(device)
    top = graph.layers[-1].tops[0]
    ref = run_graph(graph, params_to_torch(params, device), {spec.name: x})[0][top]
    got = run_graph(g2, params_to_torch(p2, device), {spec.name: x})[0][top]
    err = float((got - ref).abs().max())
    print(f"[combine] max |{top}(merged) - {top}(input)| on one batch of "
          f"{spec.shape[0]}: {err:.3e} on {device}")
    wd = _workdir(args)
    cio.export_model(g2, p2, wd / f"cb_{graph.name}.prototxt",
                     wd / f"cb_{graph.name}.caffemodel")
    print(f"[combine] artifacts -> {wd}/cb_{graph.name}.(prototxt|caffemodel)")
    return g2, p2, err


def cmd_flop(args):
    """Conv multiply and parameter counts, and the speed-up against the
    published count of `--model` when it is given, else of the registry
    model the graph is named after; `--orig-flops` overrides both. Counts
    only: nothing runs on a device."""
    from channel_pruning_tpu_torch.models import zoo
    from channel_pruning_tpu_torch.utils import flops

    graph, params = _load_model(args)
    total = flops.total_flops(graph, include_fc=False, verbose=True)
    print(f"[flop] conv mults: {total:,}")
    print(f"[param] parameters: {flops.total_params(graph, params):,}")
    denom = args.orig_flops or zoo.MODEL_REGISTRY.get(
        args.model or graph.name, {}).get("flops")
    if denom:
        print(f"[flop] {100.0 * total / denom:.2f}% of original "
              f"({denom / total:.2f}x speed-up)")
    if args.what_if_keep is not None:
        # reference `tools.py resnet` what-if: branch widths scaled by keep
        proj = flops.what_if_flops(graph, args.what_if_keep,
                                   match=args.what_if_match)
        base = denom or total
        print(f"[flop] what-if keep={args.what_if_keep} on "
              f"'{args.what_if_match}': {proj:,} mults "
              f"({100.0 * proj / base:.2f}% of original)")
    return total


def _workdir(args) -> Path:
    wd = Path(args.work_dir)
    wd.mkdir(parents=True, exist_ok=True)
    return wd


def _card(device) -> str:
    import torch

    return f"{device} ({torch.cuda.get_device_name(device)})" \
        if device.type == "cuda" else str(device)


def cmd_addbn(args):
    """Split in-place ReLUs, measure every conv output's per-channel mean
    and std on the calibration set (on `--device`), and insert BatchNorm +
    Scale after each conv so the function is unchanged (`bn_<name>`).
    Returns (graph, params)."""
    from channel_pruning_tpu_torch.convert import params_to_torch
    from channel_pruning_tpu_torch.device import resolve_device
    from channel_pruning_tpu_torch.graph.rewrite import add_bn_after_convs, split_relu
    from channel_pruning_tpu_torch.io import caffe as cio
    from channel_pruning_tpu_torch.sampling.sampler import channel_stats

    device = resolve_device(args.device)
    graph, params = _load_model(args)
    graph = split_relu(graph)
    inputs, _ = _calibration(args, graph)
    tops = {c: graph.layer(c).tops[0] for c in graph.convs}
    by_top = channel_stats(graph, params_to_torch(params, device), inputs,
                           tuple(tops.values()), device=device)
    g2, p2 = add_bn_after_convs(graph, params,
                                {c: by_top[t] for c, t in tops.items()})
    wd = _workdir(args)
    cio.export_model(g2, p2, wd / f"bn_{graph.name}.prototxt",
                     wd / f"bn_{graph.name}.caffemodel")
    print(f"[addbn] inserted BN after {len(tops)} convs -> {wd}/bn_{graph.name}")
    return g2, p2


def cmd_splitrelu(args):
    from channel_pruning_tpu_torch.graph.rewrite import split_relu
    from channel_pruning_tpu_torch.io import caffe as cio

    graph, params = _load_model(args)
    g2 = split_relu(graph)
    wd = _workdir(args)
    cio.export_model(g2, params, wd / f"s_{graph.name}.prototxt",
                     wd / f"s_{graph.name}.caffemodel")
    print(f"[splitrelu] -> {wd}/s_{graph.name}.prototxt")
    return g2


def _teacher(args, device):
    """(heads, teacher fn) for `--teacher-prototxt`, else (None, None)."""
    from channel_pruning_tpu_torch.io import caffe as cio
    from channel_pruning_tpu_torch.train import finetune as ft

    if not args.teacher_prototxt:
        return None, None
    g, p = cio.import_model(args.teacher_prototxt, args.teacher_weights,
                            batch=args.batch)
    heads = ft.distill_heads(g)
    print(f"[{args.cmd}] distilling against {g.name}: "
          + ", ".join(f"{h.tensor}({h.kind})" for h in heads))
    return heads, ft.make_teacher_fn(g, p, heads, device=device)


def _synthetic(args, graph):
    """The synthetic (x, y) stream at the model's input size, labels drawn
    below its class count (the JAX CLI draws them below 1000 whatever the
    net, which gives smaller nets labels their logits do not have)."""
    from channel_pruning_tpu_torch.graph.ir import shapes_of
    from channel_pruning_tpu_torch.ops.forward import logits_tensor_of
    from channel_pruning_tpu_torch.train.finetune import synthetic_batches

    classes = shapes_of(graph, batch=1)[logits_tensor_of(graph)][1]
    return synthetic_batches(args.batch, image=graph.inputs[0].shape[2],
                             classes=classes)


def cmd_finetune(args):
    """SGD/Nesterov finetune (the reference's `caffe train`), exported as
    `ft_<name>`: data parallel over the largest number of visible cards
    that divides `--batch` (the JAX CLI's rule), else on one device.
    Prints the steady-state ms/step (from the second step on), images/s,
    peak device memory and the loss. Returns the final TrainState."""
    import torch

    from channel_pruning_tpu_torch.device import resolve_device
    from channel_pruning_tpu_torch.io import caffe as cio
    from channel_pruning_tpu_torch.parallel import mesh as mesh_mod
    from channel_pruning_tpu_torch.train import finetune as ft
    from channel_pruning_tpu_torch.utils.config import FinetuneConfig
    from channel_pruning_tpu_torch.utils.profiling import precision_flags

    device = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    while n_dev > 1 and args.batch % n_dev:
        n_dev -= 1
    mesh = mesh_mod.make_mesh(n_dev) if n_dev > 1 else None
    if mesh is not None:
        device = mesh.lead
        print(f"[finetune] data parallel over {n_dev} devices")
    graph, params = _load_model(args)
    cfg = FinetuneConfig(base_lr=args.lr, batch_size=args.batch,
                         stepsize=args.lr_step or 200_000, gamma=args.gamma,
                         clip_gradients=args.clip_gradients)
    heads, teacher = _teacher(args, device)
    if args.data_dir:
        data = _image_batches(args, graph, shuffle=True, loop=True,
                              random_crop=True, seed=args.seed)
    else:
        data = _synthetic(args, graph)
    wd = _workdir(args)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = ft.finetune(graph, params, data, cfg, device=device,
                        max_steps=args.steps, snapshot_dir=str(wd / "snapshots"),
                        seed=args.seed, heads=heads, teacher=teacher,
                        mesh=mesh)
    ms = ft.step_ms(state)
    wall = time.perf_counter() - t0
    losses = torch.stack([m["loss"] for m in state.history]).cpu().numpy()
    mem = (f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
           if device.type == "cuda" else "not measured (cpu)")
    rate = (f"{np.mean(ms):.2f} ms/step (steps 2-{state.step}), "
            f"{args.batch * 1e3 / np.mean(ms):.1f} images/s" if ms
            else "ms/step not measured (one step)")
    print(f"[finetune] {state.step} steps at batch {args.batch} on "
          f"{_card(device)} in {wall:.2f}s: {rate}, peak "
          f"device memory {mem}; loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{int(np.isfinite(losses).sum())}/{len(losses)} finite; flags "
          f"{precision_flags()}")
    cio.export_model(graph, state.model.to_numpy(), wd / f"ft_{graph.name}.prototxt",
                     wd / f"ft_{graph.name}.caffemodel")
    print(f"[finetune] {state.step} steps -> {wd}/ft_{graph.name}.caffemodel")
    state.step_ms = ms
    return state


def cmd_eval(args):
    """Top-1/top-5 over `--data-dir` (synthetic batches without it), or
    per-head fidelity against `--teacher-prototxt`."""
    from channel_pruning_tpu_torch.device import resolve_device
    from channel_pruning_tpu_torch.train import evaluate as ev

    device = resolve_device(args.device)
    graph, params = _load_model(args)
    data = _image_batches(args, graph) if args.data_dir else _synthetic(args, graph)
    heads, teacher = _teacher(args, device)
    if heads:
        res = ev.evaluate_heads(graph, params, teacher, heads,
                                (x for x, _ in data), device=device,
                                max_batches=args.eval_batches)
    else:
        res = ev.evaluate(graph, params, data, device=device,
                          max_batches=args.eval_batches, verbose=True)
    print(json.dumps(res))
    return res


def _print_per_layer(res, other) -> None:
    by_name = {r["layer"]: r for r in (other or {}).get("layers", [])}
    hdr = f"{'layer':>20s} {'type':>12s} {'ms':>9s} {'Gmult':>8s}"
    if other:
        hdr += f" {'pruned ms':>10s} {'speedup':>8s}"
    print(hdr)
    for r in res["layers"]:
        line = (f"{r['layer']:>20s} {r['type']:>12s} {r['ms']:>9.3f} "
                f"{r['mults'] / 1e9:>8.3f}")
        o = by_name.get(r["layer"])
        if other:
            line += (f" {o['ms']:>10.3f} {r['ms'] / o['ms']:>7.2f}x"
                     if o else f" {'-':>10s} {'-':>8s}")
        print(line)
    total = f"{'TOTAL':>20s} {'':>12s} {res['sum_ms']:>9.3f}"
    if other:
        total += (f" {'':>8s} {other['sum_ms']:>10.3f} "
                  f"{res['sum_ms'] / other['sum_ms']:>7.2f}x")
        conv = [sum(r["ms"] for r in t["layers"] if r["type"] == "Convolution")
                for t in (res, other)]
        total += f"\n{'CONV':>20s} {'':>12s} {conv[0]:>9.3f} {'':>8s} " \
                 f"{conv[1]:>10.3f} {conv[0] / conv[1]:>7.2f}x"
    print(total)


def cmd_time(args):
    """Forward latency and throughput on `--device` (the reference's `caffe
    time`): per call as a caller sees it by default, `--loop-steps N`
    forwards queued back to back on the device, or `--per-layer` (with
    `--compare-prototxt`, beside a second model)."""
    from channel_pruning_tpu_torch.device import resolve_device
    from channel_pruning_tpu_torch.utils.profiling import (time_forward,
                                                           time_forward_device_loop,
                                                           time_per_layer)

    device = resolve_device(args.device)
    graph, params = _load_model(args)
    if args.per_layer:
        res = time_per_layer(graph, params, device=device, batch=args.batch,
                             steps=args.per_layer_steps, compute_dtype=args.dtype)
        other = None
        if args.compare_prototxt:
            from channel_pruning_tpu_torch.io import caffe as cio
            g2, p2 = cio.import_model(args.compare_prototxt,
                                      args.compare_weights, batch=args.batch)
            from channel_pruning_tpu_torch.models.vgg import init_params
            other = time_per_layer(g2, p2 or init_params(g2, seed=0),
                                   device=device, batch=args.batch,
                                   steps=args.per_layer_steps,
                                   compute_dtype=args.dtype)
            res["compare"] = other
        _print_per_layer(res, other)
    elif args.loop_steps:
        res = time_forward_device_loop(graph, params, device=device,
                                       batch=args.batch, steps=args.loop_steps,
                                       compute_dtype=args.dtype)
    else:
        res = time_forward(graph, params, device=device, batch=args.batch,
                           iters=args.iters, compute_dtype=args.dtype)
    print(json.dumps(res))
    return res


def cmd_deploy(args):
    """Export the parameter-baked forward as a `torch.export` archive
    (`<name>.pt2`) on `--device`; returns its path."""
    from channel_pruning_tpu_torch import deploy
    from channel_pruning_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    graph, params = _load_model(args)
    out = args.out or str(_workdir(args) / f"{graph.name}.pt2")
    size = deploy.export_serialized(graph, params, out, batch=args.batch,
                                    output=args.output, device=device)
    print(f"[deploy] {out}: {size:,} bytes (batch "
          f"{args.batch or graph.inputs[0].shape[0]}, {_card(device)})")
    return out


# the reference's released-model accuracy table (reference README.md:20-26);
# ImageNet-val fractions. `verify-release --expect <key>` compares against it.
RELEASED_ACCURACY = {
    "channel_pruning_5x": {"accuracy@1": 0.678, "accuracy@5": 0.881},
    "vgg16_3c_4x": {"accuracy@1": 0.706, "accuracy@5": 0.899},
    "resnet50_2x": {"accuracy@1": 0.723, "accuracy@5": 0.908},
}


def cmd_verify_release(args):
    """The reference's release acceptance protocol: `caffe test -iterations
    5000` over val batches of 10 with bicubic resize 256, center crop 224
    and BGR mean subtraction, then the top-1/top-5 delta against the
    published table:

        cli verify-release --prototxt channel_pruning.prototxt \\
            --weights channel_pruning.caffemodel --data-dir <imagenet-val> \\
            --mean bgr.binaryproto --expect channel_pruning_5x
    """
    from channel_pruning_tpu_torch.data import pipeline as dp
    from channel_pruning_tpu_torch.device import resolve_device
    from channel_pruning_tpu_torch.train import evaluate as ev

    if not args.data_dir:
        raise SystemExit("verify-release needs --data-dir (the val set: "
                         "imagefolder or Caffe LMDB)")
    device = resolve_device(args.device)
    graph, params = _load_model(args)
    crop = graph.inputs[0].shape[2]
    mean = None
    if args.mean:
        mean = (dp.load_mean_file(args.mean) if str(args.mean).endswith(".npy")
                else dp.load_binaryproto_mean(args.mean, crop=crop))
        print(f"[verify] mean file {args.mean}: shape {mean.shape}")
        mean = dp.as_pixel_mean(mean)
    res = ev.evaluate(graph, params, _image_batches(args, graph, mean=mean),
                      device=device,
                      max_batches=args.iterations, verbose=True)
    expect = {}
    if args.expect:
        if args.expect not in RELEASED_ACCURACY:
            raise SystemExit(f"--expect {args.expect!r}: unknown release; "
                             f"have {sorted(RELEASED_ACCURACY)}")
        expect = dict(RELEASED_ACCURACY[args.expect])
    if args.expect_top1 is not None:
        expect["accuracy@1"] = args.expect_top1
    if args.expect_top5 is not None:
        expect["accuracy@5"] = args.expect_top5
    out = {"measured": res, "protocol": {
        "iterations": args.iterations, "batch": args.batch,
        "resize": _resize_dim(crop), "crop": crop,
        "mean": str(args.mean) if args.mean else "BGR pixel mean"}}
    if expect:
        deltas = {k: round(res[k] - v, 4) for k, v in expect.items()}
        ok = all(res[k] >= v - args.tolerance for k, v in expect.items())
        out.update(expected=expect, delta=deltas, tolerance=args.tolerance,
                   verdict="PASS" if ok else "FAIL")
        for k, v in expect.items():
            print(f"[verify] {k}: measured {res[k]:.4f} vs released {v:.4f} "
                  f"(delta {deltas[k]:+.4f})")
        print(f"[verify] {out['verdict']} (tolerance {args.tolerance})")
    print(json.dumps(out))
    return out


def main(argv=None, *, cal_inputs=None):
    """Run one subcommand. `cal_inputs`, a host array (cal_batches,
    cal_batch, C, H, W), is the calibration set of `prune` in place of
    `--data-dir` or the synthetic set (callers in Python only: a seeded
    numpy set that another package can regenerate bit for bit)."""
    parser = argparse.ArgumentParser(prog="channel_pruning_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def command(name, fn, help, *, device=None, data=False, cal=False):
        """A subparser with the model arguments; `device` (its help text)
        adds --device, `data` the dataset arguments, `cal` the calibration
        set's size."""
        p = sub.add_parser(name, help=help)
        p.add_argument("--model", default="vgg16")
        p.add_argument("--prototxt", default=None)
        p.add_argument("--weights", default=None)
        p.add_argument("--batch", type=int, default=10)
        p.add_argument("--image-size", type=int, default=None)
        p.add_argument("--work-dir", default="work")
        if device:
            p.add_argument("--device", default="cuda", help=device)
        if data:
            p.add_argument("--data-dir", default=None,
                           help="imagefolder or Caffe LMDB (synthetic without)")
            p.add_argument("--seed", type=int, default=0)
            p.add_argument("--input-scale", type=float, default=1.0,
                           help="multiply mean-subtracted pixels by this "
                                "(Caffe transform_param.scale)")
        if cal:
            p.add_argument("--cal-batches", type=int, default=50)
            p.add_argument("--cal-batch", type=int, default=10)
        p.set_defaults(fn=fn)
        return p

    run_on = "cuda (default) or cpu; never chosen implicitly"
    p = command("prune", cmd_prune, "channel pruning, 3C or 2C compression",
                device=run_on, data=True, cal=True)
    p.add_argument("--set", action="append", metavar="KEY=VAL",
                   help="nested config override, e.g. dic.rank_tol=0.2")
    p.add_argument("--mode", choices=["prune", "3c", "2c"], default="prune",
                   help="prune: channel pruning; 3c: spatial + channel "
                        "decomposition and pruning; 2c: decomposition only")
    p.add_argument("--speed", type=float, default=5.0)
    p.add_argument("--ranks", default=None, help="json file {conv: rank}")
    p.add_argument("--channels", default=None, help="json file {conv: keep}")
    p.add_argument("--refreeze", action="store_true")

    command("combine", cmd_combine, "merge H into P convs (combineHP)",
            device="where the merged model is checked against the input: "
                   "cuda (default) or cpu")
    command("addbn", cmd_addbn, "measure stats and insert BN for finetune",
            device=run_on, data=True, cal=True)
    command("splitrelu", cmd_splitrelu, "make in-place ReLUs addressable")

    p = command("flop", cmd_flop, "FLOPs accounting")
    p.set_defaults(model=None)     # the ratio's registry model: --model if given
    p.add_argument("--orig-flops", type=int, default=None)
    p.add_argument("--what-if-keep", type=float, default=None,
                   help="project FLOPs with matching conv outputs scaled by "
                        "this keep ratio (tools.py resnet what-if)")
    p.add_argument("--what-if-match", default="branch2a",
                   help="substring selecting the convs to scale")

    p = command("finetune", cmd_finetune, "SGD finetune on one device",
                device=run_on, data=True)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--lr-step", type=int, default=None,
                   help="step-decay interval (solver.prototxt stepsize)")
    p.add_argument("--gamma", type=float, default=0.1)
    p.add_argument("--clip-gradients", type=float, default=0.0,
                   help="SolverParameter.clip_gradients: rescale gradients "
                        "whose global L2 norm exceeds this (0 = off); "
                        "needed when finetuning 3C-decomposed nets")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--teacher-prototxt", default=None,
                   help="distill against this frozen original net instead "
                        "of labels (RPN cls softmax + bbox SmoothL1 for "
                        "detection backbones)")
    p.add_argument("--teacher-weights", default=None)

    p = command("eval", cmd_eval, "top-1/top-5 evaluation", device=run_on,
                data=True)
    p.add_argument("--eval-batches", type=int, default=None)
    p.add_argument("--teacher-prototxt", default=None,
                   help="report per-head fidelity against this frozen "
                        "original net instead of label accuracy")
    p.add_argument("--teacher-weights", default=None)

    p = command("verify-release", cmd_verify_release,
                "released-model acceptance protocol: caffe test -iterations "
                "5000 + delta against the published table",
                device=run_on, data=True)
    p.add_argument("--iterations", type=int, default=5000,
                   help="val batches to evaluate (reference README.md:100)")
    p.add_argument("--mean", default=None,
                   help="mean file (.binaryproto or .npy); default: BGR "
                        "pixel mean")
    p.add_argument("--expect", default=None,
                   help=f"released model key: {sorted(RELEASED_ACCURACY)}")
    p.add_argument("--expect-top1", type=float, default=None)
    p.add_argument("--expect-top5", type=float, default=None)
    p.add_argument("--tolerance", type=float, default=0.001,
                   help="accepted shortfall against the released numbers")

    p = command("deploy", cmd_deploy, "export a torch.export archive (.pt2)",
                device=run_on)
    p.add_argument("--out", default=None, help="output path (.pt2)")
    p.add_argument("--output", default=None,
                   help="graph tensor to serve (default: last output)")

    p = command("time", cmd_time, "forward latency/throughput (caffe time)",
                device=run_on)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--loop-steps", type=int, default=0,
                   help="queue N forwards back to back and time them on the "
                        "device")
    p.add_argument("--dtype", default=None,
                   help="conv compute dtype for the timed forward, e.g. "
                        "bfloat16")
    p.add_argument("--per-layer", action="store_true",
                   help="per-layer forward ms table, each layer timed over "
                        "its real inputs")
    p.add_argument("--per-layer-steps", type=int, default=20,
                   help="calls per layer in one timed window")
    p.add_argument("--compare-prototxt", default=None,
                   help="also time this model and print per-layer speed-ups "
                        "beside it")
    p.add_argument("--compare-weights", default=None)

    args = parser.parse_args(argv)
    args.cal_inputs = cal_inputs
    return args.fn(args)


if __name__ == "__main__":
    main()
