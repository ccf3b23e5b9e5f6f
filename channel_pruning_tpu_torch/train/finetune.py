"""Finetuning of a (pruned) graph on one device (port of
channel_pruning_tpu/train/finetune.py).

The reference's external `caffe train` step (README.md:91: SGD, lr 1e-5,
momentum 0.9, Nesterov, step decay): the parameters live in an nn.Module
(`convert.GraphParams`), the loss is the executor's forward with gradients
on, and the update is `torch.optim.SGD` in the JAX package's optax order:
clip by the global norm, weight decay, Nesterov trace, `-lr(count)` with
lr = base_lr * gamma^floor(count / stepsize) and count from 0.

- The clip is written out as optax's `clip_by_global_norm`: t / norm * max,
  no epsilon, over every parameter's gradient, the frozen BatchNorm blobs'
  included (in JAX those are params whose update is zeroed afterwards).
- Caffe BatchNorm blobs (mean, var, factor) are frozen: they get gradients
  for the clip's norm but are not in the optimizer.
- Dropout masks come from a torch.Generator (seed `seed`), so they differ
  from the JAX package's; with no generator dropout is the identity.
- With a `mesh` (parallel/mesh) the batch is split by images over its
  shards: each runs forward and backward on its device, the gradients,
  weighted by shard size, are summed on the lead device in shard order,
  the clip and the SGD step run there, and the parameters are copied back
  to each other distinct device. One dropout seed a step serves every
  shard, each slicing the whole batch's mask, so the mesh step is the
  one-device step (as GSPMD's global mask is in JAX).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from channel_pruning_tpu_torch.convert import GraphParams, params_on
from channel_pruning_tpu_torch.graph.ir import Graph, LT
from channel_pruning_tpu_torch.ops.forward import (draw_step_seed,
                                                  logits_tensor_of, run_graph)
from channel_pruning_tpu_torch.parallel import mesh as mesh_mod
from channel_pruning_tpu_torch.utils.config import FinetuneConfig


@dataclass
class TrainState:
    model: GraphParams
    optimizer: torch.optim.Optimizer
    step: int
    # per-step metrics as device tensors, read by the caller when it wants
    history: list = field(default_factory=list)
    # the end of each step: a CUDA event recorded on the stream, or the
    # host clock on the CPU (see step_ms)
    marks: list = field(default_factory=list)
    # under a mesh: the parameters' copy on each distinct device but the lead
    replicas: dict = field(default_factory=dict)

    @property
    def params(self) -> dict[str, dict[str, torch.Tensor]]:
        return self.model.as_dict()


@dataclass(frozen=True)
class HeadSpec:
    """One loss head for multi-head finetuning (the JAX package's HeadSpec).

    kinds:
      softmax_ce      — integer labels, softmax cross-entropy;
      softmax_distill — cross-entropy against the softmax of the teacher's
                        raw head output; for conv heads (B, C, H, W)
                        `classes` folds the channel axis to (classes,
                        C // classes), e.g. 2 for the RPN anchor scores;
      smooth_l1       — SmoothL1 (sigma 1) against the teacher's output.
    """

    tensor: str
    kind: str = "softmax_ce"
    weight: float = 1.0
    classes: int = 0


def _fold_softmax_axes(t: torch.Tensor, classes: int) -> torch.Tensor:
    """(B, C, ...) -> (B, classes, C // classes * prod(...)), so the softmax
    runs over `classes` per anchor and location."""
    if classes <= 0:
        return t.reshape(t.shape[0], -1)
    b, c = t.shape[0], t.shape[1]
    rest = int(np.prod(t.shape[2:])) if t.dim() > 2 else 1
    return t.reshape(b, classes, (c // classes) * rest)


def _top5_hits(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Whether y is among the 5 largest logits, ties broken as the JAX
    package's stable argsort(...)[:, -5:] breaks them."""
    top = torch.argsort(logits, dim=-1, stable=True)[:, -5:]
    return (top == y[:, None]).any(dim=-1)


def head_loss(spec: HeadSpec, pred: torch.Tensor, target: torch.Tensor):
    """(loss, agreement) of one head; agreement is the argmax match rate
    (softmax kinds) or minus the mean absolute error (smooth_l1)."""
    if spec.kind == "softmax_ce":
        loss = F.cross_entropy(pred, target.long())
        return loss, (pred.argmax(-1) == target).float().mean()
    if spec.kind == "softmax_distill":
        p = _fold_softmax_axes(pred, spec.classes)
        t = _fold_softmax_axes(target, spec.classes)
        loss = -(torch.softmax(t, dim=1) * torch.log_softmax(p, dim=1)).sum(1).mean()
        return loss, (p.argmax(1) == t.argmax(1)).float().mean()
    if spec.kind == "smooth_l1":
        d = pred - target
        ad = d.abs()
        loss = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).mean()
        return loss, -ad.mean()
    raise ValueError(f"unknown head kind {spec.kind!r}")


def distill_heads(graph: Graph) -> tuple[HeadSpec, ...]:
    """The RPN pair for detection backbones, else one soft-target softmax
    head on the classifier logits."""
    names = {l.name for l in graph.layers}
    if "rpn_cls_score" in names and "rpn_bbox_pred" in names:
        from channel_pruning_tpu_torch.models.faster_rcnn import frcnn_heads
        return frcnn_heads(graph)
    return (HeadSpec(logits_tensor_of(graph), kind="softmax_distill"),)


def make_teacher_fn(graph: Graph, params: Mapping, heads: tuple[HeadSpec, ...],
                    *, device):
    """x -> tuple of the frozen teacher's head outputs (no gradients)."""
    input_name = graph.inputs[0].name
    tensors = tuple(h.tensor for h in heads)
    dev = params_on(params, device)

    def teacher(x):
        _, caps = run_graph(graph, dev, {input_name: x}, capture=tensors)
        return tuple(caps[t] for t in tensors)

    return teacher


def lr_at(cfg: FinetuneConfig, count: int) -> float:
    """base_lr * gamma^floor(count / stepsize), count from 0."""
    return cfg.base_lr * cfg.gamma ** (count // cfg.stepsize)


def _frozen_layers(graph: Graph) -> frozenset[str]:
    return frozenset(l.name for l in graph.by_type(LT.BN))


def make_optimizer(cfg: FinetuneConfig, model: GraphParams,
                   frozen: frozenset[str] = frozenset()) -> torch.optim.SGD:
    """SGD with weight decay and (Nesterov) momentum over every parameter
    outside the `frozen` layers; the train step sets each step's lr. The
    multi-tensor implementation on every device (PyTorch's default for
    CUDA tensors only), so a CPU run takes the card's update path; it adds
    the Nesterov term into `.grad` in place."""
    trainable = [p for n in model.names if n not in frozen
                 for p in model.layer(n).values()]
    return torch.optim.SGD(trainable, lr=cfg.base_lr, momentum=cfg.momentum,
                           dampening=0.0, weight_decay=cfg.weight_decay,
                           nesterov=bool(cfg.nesterov and cfg.momentum > 0),
                           foreach=True)


def _clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place, with no host read: grads scale
    by max / norm where norm >= max."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def build_train_step(graph: Graph, cfg: FinetuneConfig,
                     heads: tuple[HeadSpec, ...] | None = None,
                     mesh=None) -> Callable:
    """step(state, x, y, generator=None) -> (state, metrics). x: (B, C, H,
    W) f32 on the model's device; y: (B,) labels, or with `heads` a tuple
    of per-head targets and the loss is their weighted sum (metrics: top1
    is the first head's agreement, top5 the mean over heads). Metrics stay
    device tensors. Under a `mesh` (the state from `init_state(...,
    mesh=)`) x and y may lie anywhere: each shard moves its own rows."""
    input_name = graph.inputs[0].name

    if heads is None:
        logits_t = logits_tensor_of(graph)

        def loss_fn(params, x, y, generator, seed=None, rows=None):
            _, caps = run_graph(graph, params, {input_name: x},
                                capture=(logits_t,), train=True,
                                generator=generator, step_seed=seed,
                                dropout_rows=rows)
            logits = caps[logits_t]
            loss = F.cross_entropy(logits, y.long())
            acc1 = (logits.argmax(-1) == y).float().mean()
            return loss, (acc1, _top5_hits(logits, y).float().mean())
    else:
        tensors = tuple(h.tensor for h in heads)

        def loss_fn(params, x, y, generator, seed=None, rows=None):
            _, caps = run_graph(graph, params, {input_name: x},
                                capture=tensors, train=True, generator=generator,
                                step_seed=seed, dropout_rows=rows)
            total, agrees = 0.0, []
            for spec, target in zip(heads, y):
                l, agree = head_loss(spec, caps[spec.tensor], target)
                total = total + spec.weight * l
                agrees.append(agree)
            return total, (agrees[0], sum(agrees) / len(agrees))

    def update(state: TrainState) -> None:
        model = state.model
        if cfg.clip_gradients:
            _clip_by_global_norm([p.grad for p in model.parameters()
                                  if p.grad is not None], cfg.clip_gradients)
        for group in state.optimizer.param_groups:
            group["lr"] = lr_at(cfg, state.step)
        state.optimizer.step()
        state.step += 1

    def step(state: TrainState, x, y, generator=None) -> tuple[TrainState, dict]:
        model = state.model
        model.zero_grad(set_to_none=True)
        loss, (acc1, acc5) = loss_fn(model.as_dict(), x, y, generator)
        loss.backward()
        update(state)
        return state, {"loss": loss.detach(), "top1": acc1.detach(),
                       "top5": acc5.detach()}

    def mesh_step(state: TrainState, x, y, generator=None
                  ) -> tuple[TrainState, dict]:
        lead = state.model
        lead.zero_grad(set_to_none=True)
        params = list(lead.parameters())
        B = int(x.shape[0])
        seed = draw_step_seed(generator) if generator is not None else None
        grads = [None] * len(params)
        metrics = []
        for (lo, hi), dev in zip(mesh_mod.shard_bounds(B, mesh), mesh.devices):
            if hi == lo:
                continue
            model = state.replicas.get(dev, lead)
            ys = tuple(t[lo:hi].to(dev) for t in y) if heads is not None \
                else y[lo:hi].to(dev)
            loss, (acc1, acc5) = loss_fn(model.as_dict(), x[lo:hi].to(dev), ys,
                                         None, seed, (lo, hi, B))
            w = (hi - lo) / B
            part = torch.autograd.grad(loss * w, list(model.parameters()),
                                       allow_unused=True)
            for i, g in enumerate(part):      # summed in shard order
                if g is not None:
                    g = g.to(mesh.lead)
                    grads[i] = g if grads[i] is None else grads[i] + g
            metrics.append(torch.stack([loss.detach(), acc1.detach(),
                                        acc5.detach()]).to(mesh.lead) * w)
        for p, g in zip(params, grads):
            p.grad = g
        update(state)
        with torch.no_grad():
            for replica in state.replicas.values():
                for r, p in zip(replica.parameters(), params):
                    r.copy_(p)
        m = mesh_mod.reduce_sum(metrics, mesh)
        return state, {"loss": m[0], "top1": m[1], "top5": m[2]}

    return mesh_step if mesh_mod.is_sharded(mesh) else step


def init_state(graph: Graph, params: Mapping, cfg: FinetuneConfig, *,
               device, mesh=None) -> TrainState:
    """The model and its optimizer on `device` (under a mesh of more than
    one shard, on its lead), and a replica on each other distinct device
    of the mesh."""
    if mesh_mod.is_sharded(mesh):
        device = mesh.lead
    model = GraphParams(params, device)
    replicas = {} if not mesh_mod.is_sharded(mesh) else {
        d: GraphParams(params, d) for d in mesh.distinct if d != mesh.lead}
    return TrainState(model=model, step=0, replicas=replicas,
                      optimizer=make_optimizer(cfg, model, _frozen_layers(graph)))


def finetune(graph: Graph, params: Mapping, data_iter, cfg: FinetuneConfig, *,
             device, max_steps: int | None = None,
             snapshot_dir: str | None = None, log_every: int = 100,
             seed: int = 0,
             heads: tuple[HeadSpec, ...] | None = None,
             teacher: Callable | None = None, mesh=None) -> TrainState:
    """The `caffe train` loop over (x, y) numpy batches from `data_iter`.
    With `heads` and `teacher` (make_teacher_fn), each batch is trained
    against the frozen teacher's head outputs and its labels are ignored.
    The returned state's `history` holds every step's metrics as device
    tensors; the loop reads them only every `log_every` steps. A `mesh`
    splits each batch over its shards (data parallel; `device` is then
    its lead)."""
    if mesh_mod.is_sharded(mesh):
        device = mesh.lead
    state = init_state(graph, params, cfg, device=device, mesh=mesh)
    step_fn = build_train_step(graph, cfg, heads=heads, mesh=mesh)
    gen = torch.Generator().manual_seed(seed)
    n = max_steps if max_steps is not None else cfg.max_iter
    ckpt = None
    if snapshot_dir is not None:
        from channel_pruning_tpu_torch.train.checkpoint import Checkpointer
        ckpt = Checkpointer(snapshot_dir)
    for i, (x, y) in enumerate(data_iter):
        if i >= n:
            break
        # under a mesh each shard moves its own rows from the host
        xd = torch.as_tensor(x)
        host = mesh_mod.is_sharded(mesh)
        if teacher is not None:
            yd = teacher(xd.to(device))
        else:
            yd = torch.as_tensor(y) if host else torch.as_tensor(y).to(device)
        xd = xd if host else xd.to(device)
        state, metrics = step_fn(state, xd, yd, gen)
        state.history.append(metrics)
        state.marks.append(_mark(device))
        if log_every and (i + 1) % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"[finetune] it {i+1}: loss {m['loss']:.4f} "
                  f"top1 {m['top1']:.3f} top5 {m['top5']:.3f}", flush=True)
        if ckpt is not None and (i + 1) % cfg.snapshot_every == 0:
            ckpt.save(state, i + 1)
    return state


def _mark(device):
    if torch.device(device).type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def step_ms(state: TrainState) -> list[float]:
    """Milliseconds from the end of each step to the end of the next (so
    the first step, which warms up, is left out), from the marks
    `finetune` left; on a card these are device-timeline times, read after
    one synchronize."""
    m = state.marks
    if m and isinstance(m[0], torch.cuda.Event):
        m[-1].synchronize()
        return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
    return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def synthetic_batches(batch: int, image: int = 224, classes: int = 1000,
                      channels: int = 3, seed: int = 0):
    """Deterministic synthetic (x, y) stream (numpy's, so both packages see
    the same batches)."""
    rng = np.random.default_rng(seed)
    while True:
        x = rng.normal(0, 1, (batch, channels, image, image)).astype(np.float32)
        y = rng.integers(0, classes, (batch,)).astype(np.int32)
        yield x, y
