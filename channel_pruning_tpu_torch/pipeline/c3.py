"""Whole-model channel pruning (port of the pruning arm of
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
degenerate layer. Not yet: fitfc and the 3C solver.
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
    kind: str = "prune"       # "gate": a Select gate in front of the consumer
    grids: int | None = None  # CD grids the fused search solved (pipelined)


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
        X = None
        if roll is not None:
            try:
                roll.advance_to(dev_run, bottom)
                X = roll.patches_at(cache.plan, consumer)
            except rolling_mod.FrontierError as exc:
                print(f"[rolling] fallback for {consumer}: {exc}")
                frontier_fallbacks.append(consumer)
        if X is None:
            X = sampling.sample_patches(g_run, dev_run, cache.inputs, consumer,
                                        cache.plan, device=device,
                                        chunk_batches=chunk)
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
