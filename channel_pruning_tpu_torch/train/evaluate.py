"""Top-1 / top-5 evaluation (port of channel_pruning_tpu/train/evaluate.py):
the reference's `caffe test` as a batched forward over an iterator. The
per-batch counts stay on the device and are read once at the end."""
from __future__ import annotations

from typing import Iterable, Mapping

import torch

from channel_pruning_tpu_torch.convert import params_on
from channel_pruning_tpu_torch.graph.ir import Graph
from channel_pruning_tpu_torch.ops.forward import logits_tensor_of, run_graph
from channel_pruning_tpu_torch.parallel import mesh as mesh_mod
from channel_pruning_tpu_torch.train.finetune import _top5_hits, head_loss


def build_eval_step(graph: Graph):
    """step(params, x, y) -> (top-1 hits, top-5 hits) as device scalars."""
    logits_t = logits_tensor_of(graph)
    input_name = graph.inputs[0].name

    def step(params, x, y):
        _, caps = run_graph(graph, params, {input_name: x}, capture=(logits_t,))
        logits = caps[logits_t]
        return (logits.argmax(-1) == y).sum(), _top5_hits(logits, y).sum()

    return step


def evaluate(graph: Graph, params: Mapping, batches: Iterable, *, device,
             max_batches: int | None = None, verbose: bool = False,
             mesh=None) -> dict:
    """Accumulate top-1/top-5 over (x, y) numpy batches: {"accuracy@1",
    "accuracy@5", "n_images"}. A `mesh` splits each batch over its shards
    (`device` is then its lead); the shards' counts are summed there."""
    step = build_eval_step(graph)
    sharded = mesh_mod.is_sharded(mesh)
    if sharded:
        device = mesh.lead
    dev = params_on(params, device)
    by_dev = mesh_mod.replicate(dev, mesh) if sharded else None
    n, counts = 0, []
    for i, (x, y) in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        if sharded:
            counts.append(mesh_mod.reduce_sum(
                [torch.stack(step(by_dev[d], x[lo:hi].to(d), y[lo:hi].to(d)))
                 for (lo, hi), d in zip(mesh_mod.shard_bounds(len(x), mesh),
                                        mesh.devices) if hi > lo], mesh))
        else:
            counts.append(torch.stack(step(dev, x.to(device), y.to(device))))
        n += x.shape[0]
        if verbose and (i + 1) % 50 == 0:
            t1, t5 = torch.stack(counts).sum(0).tolist()
            print(f"[eval] {i+1} batches: top1 {t1/n:.4f} top5 {t5/n:.4f}")
    t1, t5 = torch.stack(counts).sum(0).tolist() if counts else (0, 0)
    return {"accuracy@1": t1 / max(n, 1), "accuracy@5": t5 / max(n, 1),
            "n_images": n}


def evaluate_heads(graph: Graph, params: Mapping, teacher, heads,
                   batches: Iterable, *, device,
                   max_batches: int | None = None) -> dict:
    """Per-head fidelity of a (pruned) multi-head net against its frozen
    teacher: agreement (argmax match, or -MAE for smooth_l1) and the
    weighted loss, averaged over batches."""
    input_name = graph.inputs[0].name
    tensors = tuple(h.tensor for h in heads)
    dev = params_on(params, device)
    acc_l = acc_a = None
    n = 0
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        x = batch[0] if isinstance(batch, tuple) else batch
        xd = torch.as_tensor(x).to(device)
        targets = teacher(xd)
        _, caps = run_graph(graph, dev, {input_name: xd}, capture=tensors)
        losses, agrees = [], []
        for spec, tgt in zip(heads, targets):
            l, a = head_loss(spec, caps[spec.tensor], tgt)
            losses.append(spec.weight * l)
            agrees.append(a)
        losses, agrees = torch.stack(losses), torch.stack(agrees)
        acc_l = losses if acc_l is None else acc_l + losses
        acc_a = agrees if acc_a is None else acc_a + agrees
        n += 1
    acc_l, acc_a = acc_l.tolist(), acc_a.tolist()
    out = {"n_batches": n, "loss": sum(acc_l) / max(n, 1)}
    for j, h in enumerate(heads):
        out[f"{h.tensor}:{'agree' if h.kind != 'smooth_l1' else 'neg_mae'}"] = (
            acc_a[j] / max(n, 1))
        out[f"{h.tensor}:loss"] = acc_l[j] / max(n, 1)
    return out


def evaluate_cache(graph: Graph, params, cache, *, device,
                   max_batches=None, mesh=None) -> dict:
    """Accuracy over the frozen calibration batches (the reference's
    accuracy replay over memory-preloaded batches); needs the cache's
    labels. `mesh` as in `evaluate`."""
    if cache.labels is None:
        raise ValueError("frozen cache has no labels (synthetic calibration)")
    n = cache.n_batches if max_batches is None else min(max_batches,
                                                        cache.n_batches)
    from channel_pruning_tpu_torch.sampling.inputs import device_chunk

    batches = ((device_chunk(cache.inputs, i, i + 1, "cpu"), cache.labels[i])
               for i in range(n))
    return evaluate(graph, params, batches, device=device, mesh=mesh)
