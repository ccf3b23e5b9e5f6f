"""Command-line entry point (port of `prune --mode prune` of
channel_pruning_tpu/cli.py).

    python -m channel_pruning_tpu_torch.cli prune --model vgg16 --speed 5.0
    python -m channel_pruning_tpu_torch.cli prune --model resnet50 --speed 2.0

Loads a registry model (random He-init weights, or `--weights` through the
shared Caffe codec), freezes a synthetic calibration set, prunes every
layer with LASSO selection + least-squares reconstruction, and exports the
pruned prototxt + caffemodel and the selections. `--device` defaults to
`cuda` and never falls back to the CPU.

Two defaults differ from the JAX CLI: the alpha search is host-stepped (the
JAX CLI defaults to the fused one-program search; the JAX suite pins the
two as selection-identical), and replays run in f32 (the JAX CLI's VGG bf16
replay preset is not carried over).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def _load_model(args):
    from channel_pruning_tpu.io import caffe as cio
    from channel_pruning_tpu.models import zoo
    from channel_pruning_tpu.models.vgg import init_params

    if args.prototxt:
        g, params = cio.import_model(args.prototxt, args.weights,
                                     batch=args.batch)
        return g, params or init_params(g, seed=0)
    kw = {"batch": args.batch}
    if args.image_size:
        kw["image_size"] = args.image_size
    g = zoo.get_model(args.model, **kw)
    params = init_params(g, seed=0)
    if args.weights:
        g, loaded = cio.load_weights(g, args.weights)
        params.update(loaded)
    return g, params


def _build_config(args):
    from channel_pruning_tpu.utils.config import default_config

    cfg = default_config()
    keys = set()
    for kv in args.set or []:
        key, _, val = kv.partition("=")
        keys.add(key)
        cfg = cfg.replace_nested(key, val)
    if "solve.fused_search" not in keys:
        print("[prune] host-stepped alpha search (solve.fused_search=False): "
              "the fused one-program search is not ported")
        cfg = cfg.replace_nested("solve.fused_search", False)
    return cfg


def _targets(graph, args, cfg):
    """(producer-keyed channel targets, consumer-keyed gate targets or None,
    config)."""
    from channel_pruning_tpu.models.resnet import resnet50_2x_targets
    from channel_pruning_tpu.models.vgg import VGG16_5X_CHANNELS
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


def cmd_prune(args):
    import torch

    from channel_pruning_tpu.io import caffe as cio
    from channel_pruning_tpu.pipeline.checkpoint import SolveCheckpoint
    from channel_pruning_tpu.utils import flops
    from channel_pruning_tpu_torch.convert import params_to_torch
    from channel_pruning_tpu_torch.device import resolve_device
    from channel_pruning_tpu_torch.pipeline import c3
    from channel_pruning_tpu_torch.sampling.inputs import SyntheticInputs
    from channel_pruning_tpu_torch.sampling.sampler import (
        FrozenCache, freeze, freeze_tensor_set, params_for_tensors,
        resnet_share_key)

    device = resolve_device(args.device)
    cfg = _build_config(args)
    wd = Path(args.work_dir)
    wd.mkdir(parents=True, exist_ok=True)
    phases: dict[str, float] = {}
    t0 = time.perf_counter()
    graph, params = _load_model(args)
    phases["load"] = time.perf_counter() - t0
    card = f" ({torch.cuda.get_device_name(device)})" \
        if device.type == "cuda" else ""
    print(f"[prune] model {graph.name}: {len(graph.convs)} convs, "
          f"{flops.total_flops(graph):,} mults; device {device}{card}")

    graph, params = c3.preprocess(graph, params)
    targets, input_targets, cfg = _targets(graph, args, cfg)
    c3.check_supported(graph, cfg)          # before the freeze, not after
    inputs = SyntheticInputs(n_batches=args.cal_batches, bs=args.cal_batch,
                             sample_shape=tuple(graph.inputs[0].shape[1:]),
                             seed=args.seed)
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
                       chunk_batches=max(cfg.sample.freeze_device_batch
                                         // inputs.shape[1], 1))
        del dparams
        cache.save(cache_path)
        print(f"[prune] froze calibration cache -> {cache_path}")
    phases["freeze"] = time.perf_counter() - t

    t = time.perf_counter()
    ck = SolveCheckpoint(wd / "solve_state_cp.pkl", every=3)
    res = c3.solve_prune(graph, params, cache, cfg, channel_targets=targets,
                         input_targets=input_targets, device=device,
                         checkpoint=ck)
    phases["solve"] = time.perf_counter() - t
    print(res.summary())
    orig = flops.total_flops(graph, include_fc=False)
    new = flops.total_flops(res.graph, include_fc=False)
    print(f"[prune] conv mults {orig:,} -> {new:,} ({orig / max(new, 1):.2f}x)")

    t = time.perf_counter()
    stem = wd / f"cp_{graph.name}"
    cio.export_model(res.graph, res.params, f"{stem}.prototxt",
                     f"{stem}.caffemodel")
    np.savez_compressed(f"{stem}_selections.npz", **res.selections)
    phases["export"] = time.perf_counter() - t
    print(f"[prune] artifacts -> {stem}.(prototxt|caffemodel)")
    print("[prune] wall " + " ".join(f"{k} {v:.2f}s" for k, v in phases.items())
          + f" total {time.perf_counter() - t0:.2f}s")
    res.wall = phases
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(prog="channel_pruning_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("prune", help="channel pruning (the ICCV'17 5x model)")
    p.add_argument("--model", default="vgg16")
    p.add_argument("--prototxt", default=None)
    p.add_argument("--weights", default=None)
    p.add_argument("--batch", type=int, default=10)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--work-dir", default="work")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never chosen implicitly")
    p.add_argument("--set", action="append", metavar="KEY=VAL",
                   help="nested config override, e.g. dic.rank_tol=0.2")
    p.add_argument("--mode", choices=["prune"], default="prune",
                   help="only channel pruning is ported (3c/2c are not)")
    p.add_argument("--speed", type=float, default=5.0)
    p.add_argument("--cal-batches", type=int, default=50)
    p.add_argument("--cal-batch", type=int, default=10)
    p.add_argument("--channels", default=None, help="json file {conv: keep}")
    p.add_argument("--refreeze", action="store_true")
    p.set_defaults(fn=cmd_prune)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
