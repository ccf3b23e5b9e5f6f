"""Whole-model channel pruning (port of the pruning arm of
channel_pruning_tpu/pipeline/c3.py).

Two graphs, as in the reference: `g_run`, the running graph, keeps the
original topology and receives zero-scattered reconstructions so every
activation shape stays static (asymmetric accumulated error: each layer is
sampled from the net with all earlier layers already pruned); `g_out`, the
output graph, is physically pruned with pure rewrites. Ground-truth targets
always come from the frozen cache of the original net.

Ported: `preprocess` and the SEQUENTIAL `solve_prune` loop, on chain graphs
with the rolling frontier and on residual graphs with the DAG frontier,
Select gates (`input_targets`) and residual compensation. Not yet: the
pipelined pass, fitfc, and the 3C solver.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np
import torch

from channel_pruning_tpu.graph import rewrite
from channel_pruning_tpu.graph.ir import Graph, LT
from channel_pruning_tpu.utils.config import Config
from channel_pruning_tpu_torch.convert import params_to_torch
from channel_pruning_tpu_torch.pipeline import prune as prune_mod
from channel_pruning_tpu_torch.sampling import rolling as rolling_mod
from channel_pruning_tpu_torch.sampling import sampler as sampling


def preprocess(graph: Graph, params: Mapping[str, Mapping[str, np.ndarray]]
               ) -> tuple[Graph, dict]:
    """BN fold + ReLU split (pure shared rewrites)."""
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
    from channel_pruning_tpu.graph.ir import shapes_of
    from channel_pruning_tpu.utils import flops as flops_mod

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
        return rolling_mod.RollingReplay(g_run, cache.inputs, device=device)
    if rolling_mod.estimate_cut_bytes(g_run, n_images) > budget:
        return None
    return rolling_mod.RollingReplayDAG(g_run, cache.inputs, device=device)


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
    if cfg.solve.fused_search:
        unported.append("solve.fused_search=True (the port runs the "
                        "host-stepped search; pass solve.fused_search=False)")
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


def solve_prune(graph: Graph, params: Mapping[str, Mapping[str, np.ndarray]],
                cache: sampling.FrozenCache, cfg: Config,
                channel_targets: Mapping[str, int] | None = None,
                input_targets: Mapping[str, int] | None = None,
                residual_compensate: bool = True, *, device,
                checkpoint=None, verbose: bool = True) -> SolveResult:
    """Sequential whole-model channel pruning.

    * `channel_targets` maps a PRODUCER conv to its surviving output-channel
      count (e.g. models.vgg.VGG16_5X_CHANNELS): the producer is pruned by
      LASSO-selecting its consumer's input channels and physically shrunk.
    * `input_targets` maps a CONSUMER conv to its surviving input count
      where the producer cannot shrink (residual junctions): a Select gate
      goes in front of the consumer instead.
    * With `residual_compensate`, a consumer feeding an Eltwise sum is fit
      against gt(block) - b - current(other bottoms), so the whole block
      output is reconstructed.

    `checkpoint` is a shared pipeline.checkpoint.SolveCheckpoint; its
    writes are asynchronous, so an exception joins the one in flight before
    it propagates (the last completed layer is on disk for the resume)."""
    try:
        return _solve_prune(graph, params, cache, cfg, channel_targets,
                            input_targets, residual_compensate, device,
                            checkpoint, verbose)
    except BaseException:
        if checkpoint is not None:
            checkpoint.wait()
        raise


def _solve_prune(graph, params, cache, cfg, channel_targets, input_targets,
                 residual_compensate, device, checkpoint,
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

    for i, consumer in enumerate(g_run.convs):
        if i <= resume_i:
            continue
        bottom = g_run.layer(consumer).bottoms[0]
        producer = prune_mod.producer_conv(g_run, bottom, before=consumer)
        # the JAX package's order: a gate target first; the first conv is
        # skipped only as a channel target
        target = None
        gate_only = False
        if input_targets is not None and consumer in input_targets:
            target = input_targets[consumer]
            gate_only = True
        elif channel_targets is not None and producer is not None and i > 0:
            target = channel_targets.get(producer)
        if target is None:
            continue
        n_in = p_run[consumer]["W"].shape[1]
        if target >= n_in:
            continue
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
            group=cfg.dic.grplasso, prefer=cfg.solve.band)
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
