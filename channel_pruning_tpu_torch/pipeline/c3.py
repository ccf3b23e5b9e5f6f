"""Whole-model channel pruning and 3C (port of
channel_pruning_tpu/pipeline/c3.py).

Two graphs, as in the reference: `g_run`, the running graph, keeps the
original topology and receives zero-scattered reconstructions so every
activation shape stays static (asymmetric accumulated error: each layer is
sampled from the net with all earlier layers already pruned); `g_out`, the
output graph, is physically pruned with pure rewrites. Ground-truth targets
always come from the frozen cache of the original net.

Ported: `preprocess` and `solve_prune`, on chain graphs with the rolling
frontier and on residual graphs with the DAG frontier, Select gates
(`input_targets`) and residual compensation; its default is the pipelined
pass (`_pipelined_conv_pass`, with the fused search), and the sequential
per-layer loop serves `solve.fused_search=False` and the restart after a
degenerate layer. `solve_3c` runs the 3C pass (spatial VH, ReLU-aware ITQ
and the pruning arm) and, with `dic.vh=False`, the 2C pass. Not yet:
fitfc.
"""
from __future__ import annotations

import collections
import contextlib
import math
import os
import time
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np
import torch

from channel_pruning_tpu_torch.graph import rewrite
from channel_pruning_tpu_torch.graph.ir import Graph, LT
from channel_pruning_tpu_torch.utils.config import Config
from channel_pruning_tpu_torch.convert import params_to_torch
from channel_pruning_tpu_torch.ops import lowrank
from channel_pruning_tpu_torch.pipeline import prune as prune_mod
from channel_pruning_tpu_torch.sampling import rolling as rolling_mod
from channel_pruning_tpu_torch.sampling import sampler as sampling

# CP_TPU_PHASE_TIMING=1 (the JAX package's switch) prints fenced per-layer
# timings of the pipelined pass: attribution only, since the fences
# serialise the work the pass overlaps
_PHASE_TIMING = os.environ.get("CP_TPU_PHASE_TIMING", "") == "1"
# set by chip_smoke.py: each layer's dispatch in the pipelined pass runs
# under torch.cuda.set_sync_debug_mode("error"), so a host sync there raises
CHECK_DISPATCH_SYNC = False


def preprocess(graph: Graph, params: Mapping[str, Mapping[str, np.ndarray]]
               ) -> tuple[Graph, dict]:
    """BN fold + ReLU split (pure graph rewrites)."""
    g, p = rewrite.merge_bn(graph, params)
    return rewrite.split_relu(g), p


@dataclass
class LayerReport:
    conv: str
    rank: int | None = None
    kept: int | None = None
    total: int | None = None
    alpha: float = 0.0
    rmse_before: float = 0.0
    rmse_after: float = 0.0
    seconds: float = 0.0
    replay_seconds: float = 0.0
    solve_seconds: float = 0.0
    kind: str = "prune"       # "gate": a Select gate in front of the consumer;
    #                           "3c": a decomposed layer (rMSE VH-only -> final)
    grids: int | None = None  # CD grids the fused search solved
    # a 3C layer's host seconds: spatial and channel stages, and inside them
    # the replay, the host SVDs, the ITQ loop and the checkpoint's wait
    phases: dict[str, float] = field(default_factory=dict)


@dataclass
class SolveResult:
    graph: Graph                      # output (pruned) graph
    params: dict                      # its parameters (numpy)
    reports: list[LayerReport] = field(default_factory=list)
    selections: dict[str, np.ndarray] = field(default_factory=dict)
    # layers where the rolling frontier could not serve the request and a
    # full replay was used instead (performance-only degradation)
    frontier_fallbacks: list[str] = field(default_factory=list)
    # wall seconds per CLI phase (load, freeze, solve, export)
    wall: dict[str, float] = field(default_factory=dict)
    # the pipelined pass ran to its end (False: sequential, or restarted)
    pipelined: bool = False
    # 3C layers where ITQ was rejected and the layer stayed at VH-only
    itq_degraded: list[str] = field(default_factory=list)
    # 3C layers kept completely untouched (spatial stage rejected too)
    undecomposed: list[str] = field(default_factory=list)
    # seconds of each background checkpoint write of this run (3C)
    checkpoint_writes: list[float] = field(default_factory=list)

    def summary(self) -> str:
        lines = []
        for r in self.reports:
            sel = f"{r.kept}/{r.total}" if r.kept is not None else "-"
            rk = r.rank if r.rank is not None else "-"
            lines.append(f"{r.conv:>16s}  rank={rk!s:>4s} keep={sel:>9s} "
                         f"rMSE {r.rmse_before:.4f}->{r.rmse_after:.4f} "
                         f"({r.seconds:.2f}s)")
        if self.frontier_fallbacks:
            lines.append(f"frontier fallbacks ({len(self.frontier_fallbacks)}):"
                         f" {', '.join(self.frontier_fallbacks)}")
        if self.itq_degraded:
            lines.append(f"ITQ degraded to VH-only "
                         f"({len(self.itq_degraded)}): "
                         f"{', '.join(self.itq_degraded)}")
        if self.undecomposed:
            lines.append(f"kept undecomposed ({len(self.undecomposed)}): "
                         f"{', '.join(self.undecomposed)}")
        return "\n".join(lines)


def _scatter_inputs(W_kept: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Zero-scatter a (n, kept, kh, kw) reconstruction back to full input
    width for the running graph."""
    full = np.zeros((W_kept.shape[0], keep.shape[0]) + W_kept.shape[2:],
                    W_kept.dtype)
    full[:, keep] = W_kept
    return full


def prune_targets_from_ratio(graph: Graph, speed_ratio: float,
                             skip: tuple[str, ...] = ()) -> dict[str, int]:
    """Uniform targets: each producer keeps C_out/sqrt(speed_ratio)."""
    scale = 1.0 / math.sqrt(speed_ratio)
    return {c: max(1, int(round(int(graph.layer(c).attr("num_output")) * scale)))
            for c in graph.convs if c not in skip}


def plan_uniform_targets(graph: Graph, speed_ratio: float,
                         rank_tol: float = 0.1,
                         skip: tuple[str, ...] = (),
                         with_prediction: bool = False):
    """Structure-aware uniform targets: bisect one keep fraction s so the
    SIMULATED post-prune conv-mult count hits 1/speed_ratio, accounting for
    which producers can physically shrink and for the support search
    landing at the top of the rank_tol band."""
    from channel_pruning_tpu_torch.graph.ir import shapes_of
    from channel_pruning_tpu_torch.utils import flops as flops_mod

    convs = list(graph.convs)
    shapes = shapes_of(graph, batch=1)
    base = {c: flops_mod.layer_flops(graph, shapes, c) for c in convs}

    def simulate(s: float) -> tuple[float, dict[str, int]]:
        in_scale = {c: 1.0 for c in convs}
        out_scale = {c: 1.0 for c in convs}
        for i, c in enumerate(convs):
            if i == 0 or c in skip:
                continue
            prod = prune_mod.producer_conv(graph, graph.layer(c).bottoms[0],
                                           before=c)
            if prod is None or prod in skip:
                continue
            if graph.layer(c).conv_geometry()["group"] > 1:
                continue                            # depthwise consumer: skip
            n_prod = int(graph.layer(prod).attr("num_output"))
            t = max(1, int(round(n_prod * s)))
            keep = min(n_prod, t + int(rank_tol * t)) / n_prod
            in_scale[c] = keep
            cons, p = c, prod
            while p is not None and prune_mod._sole_consumer_chain(
                    graph, p, cons):
                geo = graph.layer(p).conv_geometry()
                if geo["group"] == 1:
                    out_scale[p] = keep
                    break
                if geo["group"] == int(graph.layer(p).attr("num_output")):
                    out_scale[p] = keep             # depthwise: pass through
                    nxt = prune_mod.producer_conv(
                        graph, graph.layer(p).bottoms[0], before=p)
                    cons, p = p, nxt
                    continue
                break
        total = sum(base[c] * in_scale[c] * out_scale[c] for c in convs)
        targets = {c: max(1, int(round(
            int(graph.layer(c).attr("num_output")) * s)))
            for c in convs if c not in skip}
        return total, targets

    orig = sum(base.values())
    want = orig / speed_ratio
    lo, hi = 0.02, 1.0
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        total, _ = simulate(mid)
        if total > want:
            hi = mid
        else:
            lo = mid
    total, targets = simulate(lo)
    predicted = orig / max(total, 1)
    print(f"[plan] uniform keep fraction {lo:.3f} -> predicted "
          f"{predicted:.2f}x conv mults")
    if with_prediction:
        return targets, predicted
    return targets


def _maybe_rolling(g_run: Graph, cache: sampling.FrozenCache, device,
                   budget: int = 8 << 30):
    """The O(L) rolling frontier when the whole-set activation cut fits the
    budget: the chain variant for plain nets, the DAG-cut variant for
    residual topologies. None means full replays per layer."""
    n_images = cache.n_batches * cache.batch_size
    if rolling_mod.is_chain(g_run):
        if rolling_mod.estimate_peak_bytes(g_run, n_images) > budget:
            return None
        return rolling_mod.RollingReplay(g_run, cache.inputs, device=device,
                                         plan=cache.plan)
    if rolling_mod.estimate_cut_bytes(g_run, n_images) > budget:
        return None
    return rolling_mod.RollingReplayDAG(g_run, cache.inputs, device=device,
                                        plan=cache.plan)


def _patches(roll, g_run: Graph, dev_run, cache: sampling.FrozenCache,
             conv: str, device, chunk: int, fallbacks: list[str]
             ) -> torch.Tensor:
    """`conv`'s input patches at its planned points: from the rolling
    frontier, or from a full replay where the frontier cannot serve them
    (the conv is then recorded in `fallbacks`)."""
    if roll is not None:
        try:
            roll.advance_to(dev_run, g_run.layer(conv).bottoms[0])
            return roll.patches_at(cache.plan, conv)
        except rolling_mod.FrontierError as exc:
            print(f"[rolling] fallback for {conv}: {exc}")
            fallbacks.append(conv)
    return sampling.sample_patches(g_run, dev_run, cache.inputs, conv,
                                   cache.plan, device=device,
                                   chunk_batches=chunk)


def _residual_context(g_run: Graph, consumer_top: str):
    """If `consumer_top` feeds an Eltwise sum, return (eltwise top, other
    bottom tensors): the residual-compensation context (reference appresb,
    lib/net.py:1641-1683)."""
    for e in g_run.by_type(LT.ELTWISE):
        if consumer_top in e.bottoms and e.attr("operation", "sum") == "sum":
            return e.tops[0], tuple(b for b in e.bottoms if b != consumer_top)
    return None, ()


def check_supported(graph: Graph, cfg: Config) -> None:
    """Raise NotImplementedError for options and topologies the port's
    solve does not run yet."""
    unported = []
    if cfg.solve.dtype != "float32":
        unported.append(f"solve.dtype={cfg.solve.dtype} (the port replays in "
                        "f32 until a parity run on the card proves bf16)")
    if cfg.solve.autodet:
        unported.append("solve.autodet")
    if cfg.dic.fitfc:
        unported.append("dic.fitfc")
    if unported:
        raise NotImplementedError("not ported yet: " + "; ".join(unported))


def _ground_truth(feats_dev: dict[str, torch.Tensor],
                  cache: sampling.FrozenCache, tensor: str, device
                  ) -> torch.Tensor:
    """The frozen ground truth of `tensor` on the device, uploaded once per
    solve."""
    if tensor not in feats_dev:
        feats_dev[tensor] = torch.as_tensor(
            np.asarray(cache.feats[tensor], np.float32)).to(device)
    return feats_dev[tensor]


def _layer_items(g_run: Graph, p_run, channel_targets, input_targets,
                 resume_i: int):
    """(index, consumer, bottom, target, gate_only) of every layer to solve
    after `resume_i`, in the JAX package's order: a gate target first; the
    first conv is skipped only as a channel target."""
    items = []
    for i, consumer in enumerate(g_run.convs):
        if i <= resume_i:
            continue
        bottom = g_run.layer(consumer).bottoms[0]
        producer = prune_mod.producer_conv(g_run, bottom, before=consumer)
        target = None
        gate_only = False
        if input_targets is not None and consumer in input_targets:
            target = input_targets[consumer]
            gate_only = True
        elif channel_targets is not None and producer is not None and i > 0:
            target = channel_targets.get(producer)
        if target is None or target >= p_run[consumer]["W"].shape[1]:
            continue
        items.append((i, consumer, bottom, int(target), gate_only))
    return items


class _PipelineDegenerate(RuntimeError):
    """The pipelined pass hit a layer the fused solve cannot serve (an empty
    selection, or a frontier that cannot serve the layer); the caller
    restarts the solve on the sequential path."""


@contextlib.contextmanager
def _dispatch_guard(device):
    """With CHECK_DISPATCH_SYNC on the card, any host sync inside raises."""
    if not (CHECK_DISPATCH_SYNC and device.type == "cuda") or _PHASE_TIMING:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _to_host_async(out: prune_mod.FusedLayer, device):
    """Queue the copies of a layer's results to the host behind its solve,
    and an event after them: waiting on the event waits for this layer
    alone, not for the layers queued after it."""
    if device.type != "cuda":
        return out, None
    host = prune_mod.FusedLayer(*(v.to("cpu", non_blocking=True) for v in out))
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _pipelined_conv_pass(g_run: Graph, p_run, dev_run, g_out, p_out,
                         selections, reports, cache: sampling.FrozenCache,
                         cfg: Config, channel_targets, roll, checkpoint,
                         resume_i: int, verbose: bool, device,
                         frontier_fallbacks: list[str],
                         input_targets=None, residual_compensate: bool = True):
    """The pipelined pass (port of the JAX package's `_pipelined_conv_pass`):
    each layer's device work (frontier advance, patch gather, target build
    and `_fused_layer_solve`) is queued with no host sync, behind the layer
    before; the host's bookkeeping (reading the result, the output-graph
    rewrite, the checkpoint) trails one layer behind. Chain and DAG
    frontiers, gate-only consumers and residual compensation (Y built on
    the device from `features_at(device=True)`) all stay on this path.

    The running weights are updated on the device: `Wfull` is the
    zero-scattered reconstruction, so the next advance needs no upload.
    Each layer is solved at its own width (the JAX package pads to one
    width per kernel size only to compile once). Raises _PipelineDegenerate
    when a layer needs the sequential path's fallbacks."""
    items = _layer_items(g_run, p_run, channel_targets, input_targets,
                         resume_i)
    if not items:
        return g_out, p_out
    # the ground truth of every layer, and the row subsample drawn once (the
    # plan gives every layer the same row count), go up before the loop
    targets = {}
    for _, consumer, _, _, _ in items:
        top = g_run.layer(consumer).tops[0]
        e_top, others = (_residual_context(g_run, top) if residual_compensate
                         else (None, ()))
        if e_top is not None and e_top in cache.feats:
            targets[consumer] = (e_top, others)
        else:
            targets[consumer] = (top, ())
    feats_dev: dict[str, torch.Tensor] = {}
    for t, _ in targets.values():
        _ground_truth(feats_dev, cache, t, device)
    N = int(np.asarray(cache.feats[targets[items[0][1]][0]]).shape[0])
    n_sub = min(cfg.lasso.subsample_rows, max(N // 20, 1))
    rows = np.random.default_rng(cfg.sample.seed).integers(0, N, size=n_sub)
    rows_d = torch.as_tensor(rows, device=device)
    pending: collections.deque = collections.deque()

    def drain_one():
        nonlocal g_out, p_out
        i, consumer, (out, ev), n_in, gate_only, t0 = pending.popleft()
        if ev is not None:
            ev.synchronize()       # this layer's results are on the host
        keep = out.mask.numpy().astype(bool)
        if keep.sum() == 0:
            raise _PipelineDegenerate(f"{consumer}: empty fused selection "
                                      "(magnitude fallback needed)")
        Wfull = out.Wfull.numpy()
        b = out.b.numpy()
        res = prune_mod.PruneResult(
            keep=keep, W=Wfull[:, keep], b=b, alpha=float(out.alpha),
            rmse_before=float(out.rmse_before),
            rmse_after=float(out.rmse_after))
        p_run[consumer] = {"W": Wfull, "b": b}   # == _scatter_inputs(W, keep)
        g_out, p_out = prune_mod.apply_pruning(g_out, p_out, consumer, res,
                                               shrink_producer=not gate_only)
        selections[consumer] = keep
        dt = time.perf_counter() - t0
        kind = "gate" if gate_only else "prune"
        reports.append(LayerReport(
            conv=consumer, kept=int(keep.sum()), total=int(n_in),
            alpha=res.alpha, rmse_before=res.rmse_before,
            rmse_after=res.rmse_after, seconds=dt, kind=kind,
            grids=int(out.grids)))
        if verbose:
            print(f"[{kind}] {consumer}: keep {int(keep.sum())}/{n_in} "
                  f"rMSE {res.rmse_before:.4f}->{res.rmse_after:.4f} "
                  f"({dt:.2f}s pipelined)", flush=True)
        if checkpoint is not None:
            checkpoint.maybe_save(i, {"p_run": p_run, "g_out": g_out,
                                      "p_out": p_out,
                                      "selections": selections,
                                      "reports": reports,
                                      "frontier_fallbacks": frontier_fallbacks})

    def fence():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    diag: list[tuple[float, float, float]] = []
    for i, consumer, bottom, target, gate_only in items:
        t0 = time.perf_counter()
        n_out, n_in = p_run[consumer]["W"].shape[:2]
        with _dispatch_guard(device):
            try:
                roll.advance_to(dev_run, bottom)
                X = roll.patches_at(cache.plan, consumer)
            except rolling_mod.FrontierError as exc:
                raise _PipelineDegenerate(f"{consumer}: frontier fallback "
                                          f"needed ({exc})") from exc
            # rows were drawn against the first layer's row count
            assert X.shape[0] == N, (consumer, X.shape[0], N)
            if _PHASE_TIMING:
                t_adv = fence()
            W2d = dev_run[consumer]["W"]
            b2d = dev_run[consumer].get("b")
            if b2d is None:
                b2d = torch.zeros(n_out, dtype=torch.float32, device=device)
            t, others = targets[consumer]
            # the sequential path's expression order: bit-identical targets
            Yd = feats_dev[t] - b2d
            try:
                for o in others:
                    Yd = Yd - roll.features_at(dev_run, cache.plan, o,
                                               device=True)
            except rolling_mod.FrontierError as exc:
                raise _PipelineDegenerate(f"{consumer}: residual features "
                                          f"fallback needed ({exc})") from exc
            if _PHASE_TIMING:
                t_tgt = fence()
            out = prune_mod._fused_layer_solve(
                X.float(), W2d, Yd, rows_d, target, float(cfg.dic.rank_tol),
                float(cfg.solve.alpha), cfg.lasso.grid_size,
                cfg.lasso.max_rounds, cfg.lasso.n_sweeps, cfg.solve.band,
                float(cfg.solve.ls_ridge))
            # the device-to-device running update: the next advance needs
            # no host round trip
            dev_run[consumer] = {"W": out.Wfull, "b": out.b}
            host = _to_host_async(out, device)
        if _PHASE_TIMING:
            t_end = fence()
            diag.append((t_adv - t0, t_tgt - t_adv, t_end - t_tgt))
            print(f"[fenced-diag] {consumer}: advance+gather "
                  f"{diag[-1][0]:.2f}s target-build {diag[-1][1]:.2f}s "
                  f"fused-solve {diag[-1][2]:.2f}s", flush=True)
        pending.append((i, consumer, host, n_in, gate_only, t0))
        while len(pending) > 1:
            drain_one()
    while pending:
        drain_one()
    if _PHASE_TIMING and diag:
        tot = [sum(d[k] for d in diag) for k in range(3)]
        print(f"[fenced-diag] totals over {len(diag)} layers: "
              f"advance+gather {tot[0]:.2f}s target-build {tot[1]:.2f}s "
              f"fused-solve {tot[2]:.2f}s (fenced run: the pass overlaps "
              f"these with the host's bookkeeping)", flush=True)
    return g_out, p_out


def solve_prune(graph: Graph, params: Mapping[str, Mapping[str, np.ndarray]],
                cache: sampling.FrozenCache, cfg: Config,
                channel_targets: Mapping[str, int] | None = None,
                input_targets: Mapping[str, int] | None = None,
                residual_compensate: bool = True, *, device,
                checkpoint=None, verbose: bool = True,
                _no_pipeline: bool = False) -> SolveResult:
    """Whole-model channel pruning.

    * `channel_targets` maps a PRODUCER conv to its surviving output-channel
      count (e.g. models.vgg.VGG16_5X_CHANNELS): the producer is pruned by
      LASSO-selecting its consumer's input channels and physically shrunk.
    * `input_targets` maps a CONSUMER conv to its surviving input count
      where the producer cannot shrink (residual junctions): a Select gate
      goes in front of the consumer instead.
    * With `residual_compensate`, a consumer feeding an Eltwise sum is fit
      against gt(block) - b - current(other bottoms), so the whole block
      output is reconstructed.

    With `solve.fused_search` (the default) and a rolling frontier, the
    layers go through the pipelined pass; a layer it cannot serve restarts
    the solve on the sequential path (`_no_pipeline`), which also serves
    `solve.fused_search=False`.

    `checkpoint` is a pipeline.checkpoint.SolveCheckpoint; its
    writes are asynchronous, so an exception joins the one in flight before
    it propagates (the last completed layer is on disk for the resume)."""
    try:
        return _solve_prune(graph, params, cache, cfg, channel_targets,
                            input_targets, residual_compensate, device,
                            checkpoint, verbose, _no_pipeline)
    except BaseException:
        if checkpoint is not None:
            checkpoint.wait()
        raise


def _solve_prune(graph, params, cache, cfg, channel_targets, input_targets,
                 residual_compensate, device, checkpoint, verbose,
                 no_pipeline) -> SolveResult:
    check_supported(graph, cfg)
    device = torch.device(device)
    g_run = graph
    p_run = {k: dict(v) for k, v in params.items()}
    g_out = graph
    p_out = {k: dict(v) for k, v in params.items()}
    reports: list[LayerReport] = []
    selections: dict[str, np.ndarray] = {}
    frontier_fallbacks: list[str] = []
    resume_i = -1
    if checkpoint is not None:
        snap = checkpoint.load()
        if snap is not None:
            resume_i, st = snap
            p_run, g_out, p_out = st["p_run"], st["g_out"], st["p_out"]
            selections = st["selections"]
            reports = st["reports"]
            frontier_fallbacks = st.get("frontier_fallbacks", [])
            print(f"[resume] solve_prune continuing after layer {resume_i}")
    chunk = sampling.clamp_chunk_for_hbm(
        g_run, cache.batch_size,
        max(cfg.sample.device_batch // cache.batch_size, 1))
    # the replays never run the FC stack, so its weights stay on the host
    fcs = set(g_run.fcs)
    dev_run = params_to_torch({k: v for k, v in p_run.items() if k not in fcs},
                              device)
    feats_dev: dict[str, torch.Tensor] = {}   # ground truth, uploaded once
    roll = _maybe_rolling(g_run, cache, device)

    # the fused single-task solve cannot serve a 1x1 consumer under group
    # lasso (select_and_reconstruct routes those to the group path)
    grpl_block = cfg.dic.grplasso and any(
        g_run.layer(c).conv_geometry()["kh"]
        * g_run.layer(c).conv_geometry()["kw"] == 1 for c in g_run.convs)
    if (not no_pipeline and roll is not None and cfg.solve.fused_search
            and not grpl_block and (channel_targets or input_targets)):
        try:
            g_out, p_out = _pipelined_conv_pass(
                g_run, p_run, dev_run, g_out, p_out, selections, reports,
                cache, cfg, channel_targets, roll, checkpoint, resume_i,
                verbose, device, frontier_fallbacks,
                input_targets=input_targets,
                residual_compensate=residual_compensate)
        except _PipelineDegenerate as exc:
            print(f"[pipeline] {exc}; restarting on the sequential path")
            roll = dev_run = None      # release the frontier before rebuilding
            return solve_prune(graph, params, cache, cfg,
                               channel_targets=channel_targets,
                               input_targets=input_targets,
                               residual_compensate=residual_compensate,
                               device=device, checkpoint=checkpoint,
                               verbose=verbose, _no_pipeline=True)
        if checkpoint is not None:
            checkpoint.clear()
        return SolveResult(graph=g_out, params=p_out, reports=reports,
                           selections=selections,
                           frontier_fallbacks=frontier_fallbacks,
                           pipelined=True)

    for i, consumer, bottom, target, gate_only in _layer_items(
            g_run, p_run, channel_targets, input_targets, resume_i):
        n_in = p_run[consumer]["W"].shape[1]
        t0 = time.perf_counter()
        X = _patches(roll, g_run, dev_run, cache, consumer, device, chunk,
                     frontier_fallbacks)
        top = g_run.layer(consumer).tops[0]
        b2 = torch.as_tensor(np.asarray(p_run[consumer].get(
            "b", np.zeros(p_run[consumer]["W"].shape[0], np.float32)),
            np.float32), device=device)
        e_top, others = (_residual_context(g_run, top) if residual_compensate
                         else (None, ()))
        if e_top is not None and e_top in cache.feats:
            # fit the branch so the BLOCK output matches ground truth:
            # Y = gt(block) - b - sum of current(other bottoms), in f32 on
            # the device, in the JAX package's order
            cur = None
            if roll is not None:
                try:
                    cur = {o: roll.features_at(dev_run, cache.plan, o,
                                               device=True) for o in others}
                except rolling_mod.FrontierError as exc:
                    print(f"[rolling] features fallback for {consumer}: {exc}")
                    frontier_fallbacks.append(f"{consumer}(features)")
            if cur is None:
                cur = {o: torch.as_tensor(v).to(device) for o, v in
                       sampling.sample_features(
                           g_run, dev_run, cache.inputs, cache.plan, others,
                           device=device, chunk_batches=chunk).items()}
            Y = _ground_truth(feats_dev, cache, e_top, device) - b2
            for o in others:
                Y = Y - cur[o]
        else:
            Y = _ground_truth(feats_dev, cache, top, device) - b2
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_solve = time.perf_counter()
        res = prune_mod.select_and_reconstruct(
            X, p_run[consumer]["W"], Y, int(target),
            rank_tol=cfg.dic.rank_tol, alpha0=cfg.solve.alpha,
            subsample=cfg.lasso.subsample_rows, n_sweeps=cfg.lasso.n_sweeps,
            grid_size=cfg.lasso.grid_size, max_rounds=cfg.lasso.max_rounds,
            ridge=cfg.solve.ls_ridge, seed=cfg.sample.seed,
            group=cfg.dic.grplasso, prefer=cfg.solve.band,
            fused=cfg.solve.fused_search)
        t_end = time.perf_counter()

        # running graph: zero-scattered reconstruction (static shapes)
        p_run[consumer] = {"W": _scatter_inputs(res.W, res.keep), "b": res.b}
        dev_run[consumer] = params_to_torch({consumer: p_run[consumer]},
                                            device)[consumer]
        # output graph: physical shrink, or a Select gate at junctions
        g_out, p_out = prune_mod.apply_pruning(
            g_out, p_out, consumer, res, shrink_producer=not gate_only)
        selections[consumer] = res.keep
        reports.append(LayerReport(
            conv=consumer, kept=int(res.keep.sum()), total=int(n_in),
            alpha=res.alpha, rmse_before=res.rmse_before,
            rmse_after=res.rmse_after, seconds=t_end - t0,
            replay_seconds=t_solve - t0, solve_seconds=t_end - t_solve,
            kind="gate" if gate_only else "prune"))
        if verbose:
            print(f"[{reports[-1].kind}] {consumer}: keep {int(res.keep.sum())}/{n_in} "
                  f"rMSE {res.rmse_before:.4f}->{res.rmse_after:.4f} "
                  f"({t_end - t0:.2f}s = replay {t_solve - t0:.2f} + solve "
                  f"{t_end - t_solve:.2f})", flush=True)
        if checkpoint is not None:
            checkpoint.maybe_save(i, {"p_run": p_run, "g_out": g_out,
                                      "p_out": p_out,
                                      "selections": selections,
                                      "reports": reports,
                                      "frontier_fallbacks": frontier_fallbacks})
    if checkpoint is not None:
        checkpoint.clear()
    return SolveResult(graph=g_out, params=p_out, reports=reports,
                       selections=selections,
                       frontier_fallbacks=frontier_fallbacks)


# ---------------------------------------------------------------------------
# 3C solve: spatial (VH) + channel (ITQ) decomposition + pruning
# ---------------------------------------------------------------------------

def _absmax_finite(x) -> tuple[torch.Tensor, torch.Tensor]:
    """max|x| and its finiteness as 0-d tensors where x lives (NaN and Inf
    propagate through the max)."""
    ax = torch.as_tensor(x).float().abs().max()
    return ax, torch.isfinite(ax)


def _epscheck(*arrays, warn: float = 1e2, reject: float = 1e4) -> bool:
    """Numeric guard on decomposition factors and inputs (reference
    epscheck, lib/decompose.py:158-161: warns at 1e2/1e4). False when one
    is non-finite or beyond `reject`: the caller reverts the layer. The
    reduction runs where each array lives, so a device tensor sends two
    scalars to the host (the JAX package's `_epscheck_device`), not itself."""
    worst = 0.0
    for a in arrays:
        ax, fin = _absmax_finite(a)
        if not bool(fin):
            return False
        worst = max(worst, float(ax))
    if worst > reject:
        return False
    if worst > warn:
        print(f"[epscheck] factor magnitude {worst:.1e} exceeds {warn:.0e}")
    return True


def _relu_rel_error(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """rel_error(relu(gt), relu(pred)) as a 0-d tensor on the device."""
    g = torch.clamp(gt.float(), min=0.0)
    p = torch.clamp(pred.float(), min=0.0)
    return torch.sqrt(torch.mean((g - p) ** 2)) / \
        torch.sqrt(torch.mean(g ** 2) + 1e-30)


def ranks_for_speed(base_ranks: Mapping[str, int], speed_ratio: float,
                    no_rescale_prefix: str = "conv5") -> dict[str, int]:
    """Scale the 4x rank table by 4/speed_ratio, conv5 exempt
    (reference net.py:1323-1326)."""
    return {k: int(v) if k.startswith(no_rescale_prefix)
            else max(1, int(round(v * 4.0 / speed_ratio)))
            for k, v in base_ranks.items()}


def solve_3c(graph: Graph, params: Mapping[str, Mapping[str, np.ndarray]],
             cache: sampling.FrozenCache, cfg: Config,
             ranks: Mapping[str, int], skip: tuple[str, ...] = ("conv1_1",),
             *, device, checkpoint=None, verbose: bool = True) -> SolveResult:
    """The whole-model 3C pass (reference R3, lib/net.py:1292-1471).

    Per conv, in order, skipping `skip` and convs without a rank:
      (a) spatial: the data-driven VH SVD at rank r; the running conv's
          weights become the rank-limited VHr and the refit bias;
      (b) channel: ReLU-aware ITQ at rank r on the VH responses against the
          frozen ground truth; the running weights become the merged W12 and
          bias B (the layer stays VH-only when ITQ is rejected);
      (c) pruning (with `dic.vh`): LASSO-select the NEXT conv's inputs down
          to floor(C_out / dic.c_ratio) with `prune.select_and_reconstruct`
          (the fused search with `solve.fused_search`), least-squares
          reconstruct, zero-scatter into the running graph.
    The output graph replaces each conv with V (kh x 1) -> H (1 x kw, rank)
    -> P (1x1) and physically drops pruned channels (P's rows, or H's for a
    VH-only layer, and the consumer's input slices).

    Only conv parameters go to the device; the FC stack stays on the host.
    `checkpoint` (a pipeline.checkpoint.SolveCheckpoint) snapshots the state
    after every layer it is due on and resumes from it; an exception joins
    the write in flight before it propagates."""
    try:
        return _solve_3c(graph, params, cache, cfg, ranks, skip, device,
                         checkpoint, verbose)
    except BaseException:
        if checkpoint is not None:
            checkpoint.wait()
        raise


def _solve_3c(graph, params, cache, cfg, ranks, skip, device, checkpoint,
              verbose) -> SolveResult:
    check_supported(graph, cfg)
    device = torch.device(device)
    g_run = graph
    p_run = {k: dict(v) for k, v in params.items()}
    g_out = graph
    p_out = {k: dict(v) for k, v in params.items()}
    reports: list[LayerReport] = []
    selections: dict[str, np.ndarray] = {}
    frontier_fallbacks: list[str] = []
    itq_degraded: list[str] = []
    undecomposed: list[str] = []
    # input-keep masks recorded by the pruning arm, consumed when the conv is
    # itself decomposed (V's input channels sliced)
    input_keep: dict[str, np.ndarray] = {}
    resume_i = -1
    if checkpoint is not None:
        snap = checkpoint.load()
        if snap is not None:
            resume_i, st = snap
            p_run, g_out, p_out = st["p_run"], st["g_out"], st["p_out"]
            selections = st["selections"]
            input_keep = st["input_keep"]
            reports = st["reports"]
            frontier_fallbacks = st.get("frontier_fallbacks", [])
            itq_degraded = st.get("itq_degraded", [])
            undecomposed = st.get("undecomposed", [])
            print(f"[resume] solve_3c continuing after layer {resume_i}")

    convs = list(g_run.convs)
    chunk = sampling.clamp_chunk_for_hbm(
        g_run, cache.batch_size,
        max(cfg.sample.device_batch // cache.batch_size, 1))
    # the replays never run the FC stack, so its weights stay on the host
    fcs = set(g_run.fcs)
    dev_run = params_to_torch({k: v for k, v in p_run.items() if k not in fcs},
                              device)
    feats_dev: dict[str, torch.Tensor] = {}   # ground truth, uploaded once
    roll = _maybe_rolling(g_run, cache, device)

    def patches(conv: str) -> torch.Tensor:
        return _patches(roll, g_run, dev_run, cache, conv, device, chunk,
                        frontier_fallbacks)

    def overwrite(conv: str, W: torch.Tensor, b: torch.Tensor) -> None:
        """The running conv's new weights: on the device as computed, and
        their host copy for the checkpoint and the next stage."""
        dev_run[conv] = {"W": W.contiguous(), "b": b.contiguous()}
        p_run[conv] = {"W": W.cpu().numpy(), "b": b.cpu().numpy()}

    for i, conv in enumerate(convs):
        if i <= resume_i or conv in skip or conv not in ranks:
            continue
        rank = int(ranks[conv])
        l_run = g_run.layer(conv)
        geo = l_run.conv_geometry()
        W_cur = np.asarray(p_run[conv]["W"], np.float32)
        n_out, c_full, kh, kw = W_cur.shape
        Ygt = _ground_truth(feats_dev, cache, l_run.tops[0], device)
        phases: dict[str, float] = {}
        t0 = time.perf_counter()

        # ---- (a) spatial decomposition --------------------------------
        X = patches(conv)
        ok_in = _epscheck(X, warn=1e5, reject=1e6)
        phases["replay"] = time.perf_counter() - t0
        vh = None
        if not ok_in:
            # extreme accumulated activations: keep the layer untouched
            print(f"[3c] {conv}: inputs rejected by epscheck — layer kept")
        else:
            try:
                vh = lowrank.vh_decompose(W_cur, rank, X=X, Y=Ygt,
                                          lambdas=cfg.solve.nonlinear_lambdas,
                                          iters=cfg.solve.nonlinear_iters)
            except np.linalg.LinAlgError as exc:
                print(f"[3c] {conv}: spatial decomposition failed ({exc}) — "
                      "layer kept undecomposed")
            else:
                phases["svd_host"] = vh.svd_seconds
                if not _epscheck(vh.VHr, vh.b, vh.V, vh.H):
                    print(f"[3c] {conv}: spatial factors rejected by epscheck "
                          "— layer kept undecomposed")
                    vh = None
        if vh is None:
            undecomposed.append(conv)
            reports.append(LayerReport(conv=conv, rank=rank, kind="3c",
                                       seconds=time.perf_counter() - t0))
            continue
        overwrite(conv, vh.VHr, vh.b)
        phases["spatial"] = time.perf_counter() - t0

        # ---- (b) channel decomposition (ITQ) --------------------------
        # the post-VH responses at the sampled points are the extracted
        # patches convolved with VHr, which the refit already produced
        # (the reference re-runs a 500-batch extraction, net.py:1386)
        t1 = time.perf_counter()
        itq = None
        if _epscheck(vh.feat, warn=1e5, reject=1e6):
            try:
                itq = lowrank.itq_decompose(vh.feat, Ygt, vh.H, rank,
                                            bias=vh.b, Wr=vh.VHr,
                                            lambdas=cfg.solve.itq_lambdas,
                                            iters=cfg.solve.itq_iters)
            except np.linalg.LinAlgError as exc:
                print(f"[3c] {conv}: ITQ solve failed ({exc})")
            else:
                phases["itq_loop"] = itq.loop_seconds
                phases["itq_svd_host"] = itq.svd_seconds
                if not _epscheck(itq.W1, itq.W2, itq.B, itq.W12):
                    itq = None
        if itq is not None:
            overwrite(conv, itq.W12, itq.B)
        else:
            print(f"[3c] {conv}: ITQ factors rejected by epscheck — "
                  "layer kept at spatial (VH) decomposition only")
            itq_degraded.append(conv)
        # decomposition telemetry: relative error of the ReLU'd responses,
        # VH-only against final (VH+ITQ when it held)
        rmse_vh = float(_relu_rel_error(Ygt, vh.feat))
        rmse_final = rmse_vh if itq is None else \
            float(_relu_rel_error(Ygt, itq.feat2))
        phases["channel"] = time.perf_counter() - t1

        # ---- output graph: conv -> V, then H (and P when ITQ held) ----
        keep_in = input_keep.get(conv, np.ones(c_full, bool))
        V = vh.V.cpu().numpy()[:, keep_in]          # (rank, c_kept, kh, 1)
        if itq is not None:
            Hw, Hb = itq.W1.cpu().numpy(), None     # (rank, rank, 1, kw)
            Pw, Pb = itq.W2.cpu().numpy(), itq.B.cpu().numpy()
        else:
            Hw, Hb = vh.H.cpu().numpy(), vh.b.cpu().numpy()
        g_out, p_out = rewrite.set_conv(
            g_out, p_out, conv, W=V, b=None, bias=False,
            num_output=rank, kernel_h=kh, kernel_w=1,
            stride_h=geo["sh"], stride_w=1, pad_h=geo["ph"], pad_w=0,
            new_name=f"{conv}_V")
        p_out[f"{conv}_V"].pop("b", None)
        g_out, p_out = rewrite.insert_conv_after(
            g_out, p_out, f"{conv}_V", f"{conv}_H", Hw, Hb,
            stride=(1, geo["sw"]), pad=(0, geo["pw"]))
        if itq is not None:
            g_out, p_out = rewrite.insert_conv_after(
                g_out, p_out, f"{conv}_H", f"{conv}_P", Pw, Pb,
                stride=1, pad=(0, 0))
        report = LayerReport(conv=conv, rank=rank, rmse_before=rmse_vh,
                             rmse_after=rmse_final, kind="3c", phases=phases,
                             seconds=phases["spatial"] + phases["channel"])
        reports.append(report)

        # ---- (c) prune the next conv's inputs -------------------------
        convnext = convs[i + 1] if i + 1 < len(convs) else None
        if convnext is not None and cfg.dic.vh:
            d_c = int(math.floor(n_out / cfg.dic.c_ratio))
            t2 = time.perf_counter()
            Xn = patches(convnext)
            W_next = np.asarray(p_run[convnext]["W"], np.float32)
            b_next = np.asarray(p_run[convnext].get(
                "b", np.zeros(W_next.shape[0])), np.float32)
            Yn = _ground_truth(feats_dev, cache, g_run.layer(convnext).tops[0],
                               device) - torch.as_tensor(b_next, device=device)
            res = prune_mod.select_and_reconstruct(
                Xn, W_next, Yn, d_c, rank_tol=cfg.dic.rank_tol,
                alpha0=cfg.solve.alpha, subsample=cfg.lasso.subsample_rows,
                n_sweeps=cfg.lasso.n_sweeps, grid_size=cfg.lasso.grid_size,
                max_rounds=cfg.lasso.max_rounds, ridge=cfg.solve.ls_ridge,
                seed=cfg.sample.seed, group=cfg.dic.grplasso,
                prefer=cfg.solve.band, fused=cfg.solve.fused_search)
            t_prune = time.perf_counter() - t2
            p_run[convnext] = {"W": _scatter_inputs(res.W, res.keep),
                               "b": res.b}
            dev_run[convnext] = params_to_torch({convnext: p_run[convnext]},
                                                device)[convnext]
            input_keep[convnext] = res.keep
            selections[convnext] = res.keep
            # output graph: slice the producer's rows (P, or H when the ITQ
            # stage was rejected), install the consumer's weights
            prod_key = f"{conv}_P" if itq is not None else f"{conv}_H"
            p_out[prod_key] = {k: np.asarray(v)[res.keep]
                               for k, v in p_out[prod_key].items()}
            g_out, p_out = rewrite.set_conv(g_out, p_out, prod_key,
                                            num_output=int(res.keep.sum()))
            g_out, p_out = rewrite.prune_conv_inputs(
                g_out, p_out, convnext, res.keep, W=res.W, b=res.b)
            reports.append(LayerReport(
                conv=convnext, kept=int(res.keep.sum()), total=int(n_out),
                alpha=res.alpha, rmse_before=res.rmse_before,
                rmse_after=res.rmse_after, seconds=t_prune, grids=res.grids))
            if verbose:
                print(f"[3c] {conv}: rank {rank}; prune {convnext} "
                      f"{int(res.keep.sum())}/{n_out} rMSE "
                      f"{res.rmse_before:.4f}->{res.rmse_after:.4f}", flush=True)
        elif verbose:
            print(f"[3c] {conv}: rank {rank}", flush=True)
        if checkpoint is not None:
            # the key goes in before the snapshot: the writer thread pickles
            # this dict, and only the value changes under it
            phases["checkpoint"] = 0.0
            t3 = time.perf_counter()
            checkpoint.maybe_save(i, {"p_run": p_run, "g_out": g_out,
                                      "p_out": p_out,
                                      "selections": selections,
                                      "input_keep": input_keep,
                                      "reports": reports,
                                      "frontier_fallbacks": frontier_fallbacks,
                                      "itq_degraded": itq_degraded,
                                      "undecomposed": undecomposed})
            phases["checkpoint"] = time.perf_counter() - t3

    writes: list[float] = []
    if checkpoint is not None:
        checkpoint.clear()
        writes = list(checkpoint.write_seconds)
    g_out.validate()
    n_3c = sum(1 for c in convs if c not in skip and c in ranks)
    n_deg = len(itq_degraded) + len(undecomposed)
    print(f"[3c] {n_3c - n_deg}/{n_3c} layers fully decomposed "
          f"(VH+ITQ); {len(itq_degraded)} VH-only, "
          f"{len(undecomposed)} untouched")
    return SolveResult(graph=g_out, params=p_out, reports=reports,
                       selections=selections,
                       frontier_fallbacks=frontier_fallbacks,
                       itq_degraded=itq_degraded, undecomposed=undecomposed,
                       checkpoint_writes=writes)
