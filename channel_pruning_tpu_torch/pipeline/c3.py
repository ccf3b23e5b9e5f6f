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
per-layer loop serves `solve.fused_search=False`, autodet, group lasso on
graphs with 1x1 convs and the restart after a degenerate layer; with
`dic.fitfc` the last conv's outputs are then pruned through the first FC
layer's inputs (`_fitfc_pass`). `solve_3c` runs the 3C pass (spatial VH,
ReLU-aware ITQ and the pruning arm) and, with `dic.vh=False`, the 2C pass.
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
from channel_pruning_tpu_torch.ops import lasso as lasso_mod
from channel_pruning_tpu_torch.ops import lowrank
from channel_pruning_tpu_torch.parallel import mesh as mesh_mod
from channel_pruning_tpu_torch.pipeline import prune as prune_mod
from channel_pruning_tpu_torch.sampling import rolling as rolling_mod
from channel_pruning_tpu_torch.sampling import sampler as sampling
from channel_pruning_tpu_torch.utils import trace

# CP_TPU_PHASE_TIMING=1 (the JAX package's switch) traces `solve_prune`
# (utils/trace) and prints each layer's host self time and device time per
# span of the pass at its end, without fencing the work the pass overlaps
_PHASE_TIMING = os.environ.get("CP_TPU_PHASE_TIMING", "") == "1"
# the spans of the pipelined pass, a layer each, in the order they run
PASS_SPANS = ("pass.advance", "pass.target", "pass.solve", "solve.gram",
              "solve.search", "solve.fit", "pass.to_host", "pass.drain_wait",
              "pass.bookkeep")
# set by chip_smoke.py: each layer's dispatch in the pipelined pass runs
# under torch.cuda.set_sync_debug_mode("error"), so a host sync there raises
CHECK_DISPATCH_SYNC = False


def preprocess(graph: Graph, params: Mapping[str, Mapping[str, np.ndarray]]
               ) -> tuple[Graph, dict]:
    """BN fold + ReLU split (pure graph rewrites)."""
    with trace.span("preprocess"):
        with trace.span("preprocess.merge_bn"):
            g, p = rewrite.merge_bn(graph, params)
        with trace.span("preprocess.split_relu"):
            return rewrite.split_relu(g), p


@dataclass
class LayerReport:
    conv: str
    rank: int | None = None   # a 3C layer's rank
    target: int | None = None  # a pruned layer's planned kept count
    kept: int | None = None
    total: int | None = None
    alpha: float = 0.0
    rmse_before: float = 0.0
    rmse_after: float = 0.0
    seconds: float = 0.0
    replay_seconds: float = 0.0
    solve_seconds: float = 0.0
    kind: str = "prune"       # "gate": a Select gate in front of the consumer;
    #                           "3c": a decomposed layer (rMSE VH-only -> final);
    #                           "fc": the FC consumer of fitfc
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
                   compute_dtype: str | None = None, budget: int = 8 << 30,
                   mesh=None):
    """The O(L) rolling frontier when the whole-set activation cut fits the
    budget: the chain variant for plain nets, the DAG-cut variant for
    residual topologies. None means full replays per layer. The frontier
    is f32 whatever `compute_dtype` its convs run in. Under a mesh its
    image axis is split over the shards, and the budget scales with the
    mesh's distinct devices, not its shards: logical shards on one card
    share that card's memory."""
    n_images = cache.n_batches * cache.batch_size
    if mesh is not None:
        budget *= len(mesh.distinct)
    if rolling_mod.is_chain(g_run):
        if rolling_mod.estimate_peak_bytes(g_run, n_images) > budget:
            return None
        return rolling_mod.RollingReplay(g_run, cache.inputs, device=device,
                                         plan=cache.plan,
                                         compute_dtype=compute_dtype,
                                         mesh=mesh)
    if rolling_mod.estimate_cut_bytes(g_run, n_images) > budget:
        return None
    return rolling_mod.RollingReplayDAG(g_run, cache.inputs, device=device,
                                        plan=cache.plan,
                                        compute_dtype=compute_dtype,
                                        mesh=mesh)


def _replay_dtype(cfg: Config) -> str | None:
    """The replays' conv dtype, as the JAX package's `cdt`: None for f32."""
    return None if cfg.solve.dtype == "float32" else cfg.solve.dtype


def _patches(roll, g_run: Graph, dev_run, cache: sampling.FrozenCache,
             conv: str, device, chunk: int, fallbacks: list[str],
             compute_dtype: str | None = None, mesh=None) -> torch.Tensor:
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
                                   chunk_batches=chunk,
                                   compute_dtype=compute_dtype, mesh=mesh)


def _layer_target(g_run: Graph, cache: sampling.FrozenCache, consumer: str,
                  residual_compensate: bool) -> tuple[str, tuple[str, ...]]:
    """(the frozen tensor `consumer` is fit against, the junction summands
    subtracted from it). With `residual_compensate`, a consumer feeding an
    Eltwise sum whose output was frozen fits the block's output less the
    sum's other bottoms (reference appresb, lib/net.py:1641-1683);
    otherwise it fits its own output."""
    top = g_run.layer(consumer).tops[0]
    if residual_compensate:
        for e in g_run.by_type(LT.ELTWISE):
            if top in e.bottoms and e.attr("operation", "sum") == "sum":
                if e.tops[0] in cache.feats:
                    return e.tops[0], tuple(b for b in e.bottoms if b != top)
                break
    return top, ()


def check_supported(graph: Graph, cfg: Config) -> None:
    """Raise ValueError for a `solve.dtype` the replays do not run (the JAX
    package's names for f32 and bf16 only)."""
    if cfg.solve.dtype not in sampling.REPLAY_DTYPES:
        raise ValueError(f"solve.dtype={cfg.solve.dtype}: the replays run in "
                         f"one of {', '.join(sampling.REPLAY_DTYPES)}")


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
    if not (CHECK_DISPATCH_SYNC and device.type == "cuda"):
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
    host = prune_mod.FusedLayer(*(None if v is None else
                                  v.to("cpu", non_blocking=True) for v in out))
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _pipelined_conv_pass(g_run: Graph, p_run, dev_run,
                         cache: sampling.FrozenCache, cfg: Config,
                         channel_targets, roll, record, resume_i: int, device,
                         input_targets=None, residual_compensate: bool = True,
                         mesh=None):
    """The pipelined pass (port of the JAX package's `_pipelined_conv_pass`):
    each layer's device work (frontier advance, patch gather, target build
    and `_fused_layer_solve`) is queued with no host sync, behind the layer
    before; the host's bookkeeping (reading the result, then `record`: the
    output-graph rewrite, the report, the checkpoint) trails one layer
    behind. Chain and DAG frontiers, gate-only consumers and residual
    compensation (Y built on the device from `features_at(device=True)`)
    all stay on this path.

    The running weights are updated on the device: `Wfull` is the
    zero-scattered reconstruction, so the next advance needs no upload.
    Each layer is solved at its own width (the JAX package pads to one
    width per kernel size only to compile once). Raises _PipelineDegenerate
    when a layer needs the sequential path's fallbacks.

    Under a `mesh` the frontier advances each shard's images on its device
    and `_fused_layer_solve` takes X and Y split by rows (when N is a
    multiple of the shard count), with the row subsample split per shard
    before the loop: the layer's dispatch stays free of host syncs."""
    items = _layer_items(g_run, p_run, channel_targets, input_targets,
                         resume_i)
    if not items:
        return
    # the ground truth of every layer, and the row subsample drawn once (the
    # plan gives every layer the same row count), go up before the loop
    targets = {consumer: _layer_target(g_run, cache, consumer,
                                       residual_compensate)
               for _, consumer, _, _, _ in items}
    feats_dev: dict[str, torch.Tensor] = {}
    with trace.span("pass.upload"):
        for t, _ in targets.values():
            _ground_truth(feats_dev, cache, t, device)
        N = int(np.asarray(cache.feats[targets[items[0][1]][0]]).shape[0])
        n_sub = min(cfg.lasso.subsample_rows, max(N // 20, 1))
        rows = np.random.default_rng(cfg.sample.seed).integers(0, N, size=n_sub)
        solve_mesh = mesh if mesh_mod.is_sharded(mesh) and N % mesh.size == 0 \
            else None
        rows_d = prune_mod.split_rows(rows, N, mesh) if solve_mesh is not None \
            else torch.as_tensor(rows, device=device)
    pending: collections.deque = collections.deque()

    def drain_one():
        i, consumer, (out, ev), n_in, target, gate_only, t0 = pending.popleft()
        with trace.span("pass.drain_wait", consumer):
            if ev is not None:
                ev.synchronize()   # this layer's results are on the host
        with trace.span("pass.bookkeep", consumer):
            keep = out.mask.numpy().astype(bool)
            if keep.sum() == 0:
                raise _PipelineDegenerate(f"{consumer}: empty fused selection "
                                          "(magnitude fallback needed)")
            Wfull = out.Wfull.numpy()
            lasso_mod.count_sweeps(out.cd)
            res = prune_mod.PruneResult(
                keep=keep, W=Wfull[:, keep], b=out.b.numpy(),
                alpha=float(out.alpha), rmse_before=float(out.rmse_before),
                rmse_after=float(out.rmse_after))
            # Wfull == _scatter_inputs(res.W, keep)
            record(i, consumer, res, Wfull, n_in, target, gate_only,
                   "pipelined", seconds=time.perf_counter() - t0,
                   grids=int(out.grids))

    for i, consumer, bottom, target, gate_only in items:
        t0 = time.perf_counter()
        n_out, n_in = p_run[consumer]["W"].shape[:2]
        with _dispatch_guard(device):
            with trace.span("pass.advance", consumer):
                try:
                    roll.advance_to(dev_run, bottom)
                    X = roll.patches_at(cache.plan, consumer)
                except rolling_mod.FrontierError as exc:
                    raise _PipelineDegenerate(f"{consumer}: frontier fallback "
                                              f"needed ({exc})") from exc
            # rows were drawn against the first layer's row count
            assert X.shape[0] == N, (consumer, X.shape[0], N)
            with trace.span("pass.target", consumer):
                W2d = dev_run[consumer]["W"]
                b2d = dev_run[consumer].get("b")
                if b2d is None:
                    b2d = torch.zeros(n_out, dtype=torch.float32, device=device)
                t, others = targets[consumer]
                # the sequential path's expression order: bit-identical
                Yd = feats_dev[t] - b2d
                try:
                    for o in others:
                        Yd = Yd - roll.features_at(dev_run, cache.plan, o,
                                                   device=True)
                except rolling_mod.FrontierError as exc:
                    raise _PipelineDegenerate(f"{consumer}: residual features "
                                              f"fallback needed ({exc})") from exc
            with trace.span("pass.solve", consumer):
                out = prune_mod._fused_layer_solve(
                    X.float(), W2d, Yd, rows_d, target,
                    float(cfg.dic.rank_tol), float(cfg.solve.alpha),
                    cfg.lasso.grid_size, cfg.lasso.max_rounds,
                    cfg.lasso.n_sweeps, cfg.solve.band,
                    float(cfg.solve.ls_ridge), mesh=solve_mesh)
                # the device-to-device running update: the next advance
                # needs no host round trip
                dev_run[consumer] = {"W": out.Wfull, "b": out.b}
            with trace.span("pass.to_host", consumer):
                host = _to_host_async(out, device)
        pending.append((i, consumer, host, n_in, target, gate_only, t0))
        while len(pending) > 1:
            drain_one()
    while pending:
        drain_one()


def solve_prune(graph: Graph, params: Mapping[str, Mapping[str, np.ndarray]],
                cache: sampling.FrozenCache, cfg: Config,
                channel_targets: Mapping[str, int] | None = None,
                input_targets: Mapping[str, int] | None = None,
                residual_compensate: bool = True, *, device,
                checkpoint=None, verbose: bool = True, mesh=None,
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

    `solve.dtype` ("bfloat16" or "bf16") runs every replay's convs as the
    JAX package does (`_replay_dtype`): operands rounded to bf16, f32
    products, sums and outputs; the frozen ground truth, fitfc's dense
    capture and all solver math stay f32.

    `checkpoint` is a pipeline.checkpoint.SolveCheckpoint; its
    writes are asynchronous, so an exception joins the one in flight before
    it propagates (the last completed layer is on disk for the resume).

    A `mesh` (parallel/mesh) of more than one shard, whose lead takes the
    place of `device`, splits the frontier's images and the solvers' row
    reductions over its shards; the selections are the one-device ones.

    The solve runs in the span `pass` (utils/trace); with
    CP_TPU_PHASE_TIMING=1 it turns tracing on if it is off and prints
    `PASS_SPANS`' host self and device seconds a layer at the end (the
    tracer's clock anchors synchronize at the solve's start and end, and
    nothing inside it)."""
    owns = _PHASE_TIMING and not trace.enabled()
    if owns:
        trace.enable(_lead(device, mesh)[0])
    first = len(trace.records()) if _PHASE_TIMING and not owns else 0
    try:
        with trace.span("pass"):
            res = _solve_prune(graph, params, cache, cfg, channel_targets,
                               input_targets, residual_compensate, device,
                               checkpoint, verbose, _no_pipeline, mesh)
    except BaseException:
        if checkpoint is not None:
            checkpoint.wait()
        raise
    finally:
        if owns:
            trace.disable()
    if _PHASE_TIMING:
        print("\n".join(trace.layer_table(trace.records()[first:], PASS_SPANS,
                                          "phase-timing")), flush=True)
    return res


def _lead(device, mesh) -> tuple[torch.device, object]:
    """(the solve's device, the mesh or None): a mesh of more than one
    shard replaces `device` with its lead."""
    if mesh_mod.is_sharded(mesh):
        return mesh.lead, mesh
    return torch.device(device), None


def _solve_prune(graph, params, cache, cfg, channel_targets, input_targets,
                 residual_compensate, device, checkpoint, verbose,
                 no_pipeline, mesh) -> SolveResult:
    check_supported(graph, cfg)
    device, mesh = _lead(device, mesh)
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

    def record(i, consumer, res, Wfull, n_in, target, gate_only, how,
               **timing):
        """Record a solved layer, for both loops below: the running host
        weights (`Wfull`, the zero-scattered reconstruction: static
        shapes), the output graph's physical shrink or, at a junction, its
        Select gate, the selection, the report (`timing`: the loop's own
        LayerReport fields, `seconds` among them), the `[prune]`/`[gate]`
        line (`how`: its timing note) and the checkpoint."""
        nonlocal g_out, p_out
        p_run[consumer] = {"W": Wfull, "b": res.b}
        g_out, p_out = prune_mod.apply_pruning(
            g_out, p_out, consumer, res, shrink_producer=not gate_only)
        selections[consumer] = res.keep
        kind = "gate" if gate_only else "prune"
        kept = int(res.keep.sum())
        reports.append(LayerReport(
            conv=consumer, target=target, kept=kept, total=int(n_in),
            alpha=res.alpha, rmse_before=res.rmse_before,
            rmse_after=res.rmse_after, kind=kind, **timing))
        if verbose:
            print(f"[{kind}] {consumer}: keep {kept}/{n_in} "
                  f"rMSE {res.rmse_before:.4f}->{res.rmse_after:.4f} "
                  f"({timing['seconds']:.2f}s {how})", flush=True)
        if checkpoint is not None:
            checkpoint.maybe_save(i, {"p_run": p_run, "g_out": g_out,
                                      "p_out": p_out,
                                      "selections": selections,
                                      "reports": reports,
                                      "frontier_fallbacks": frontier_fallbacks})

    chunk = sampling.clamp_chunk_for_hbm(
        g_run, cache.batch_size,
        max(cfg.sample.device_batch // cache.batch_size, 1))
    # the replays run the FC stack only under fitfc; otherwise its weights
    # stay on the host
    fitfc = bool(cfg.dic.fitfc and channel_targets)
    fcs = set() if fitfc else set(g_run.fcs)
    dev_run = params_to_torch({k: v for k, v in p_run.items() if k not in fcs},
                              device)
    feats_dev: dict[str, torch.Tensor] = {}   # ground truth, uploaded once
    cdt = _replay_dtype(cfg)       # the replays' convs; fitfc's capture f32
    with trace.span("pass.upload"):        # the frontier's images
        roll = _maybe_rolling(g_run, cache, device, cdt, mesh=mesh)

    # the fused single-task solve cannot serve a 1x1 consumer under group
    # lasso (select_and_reconstruct routes those to the group path), nor
    # autodet's one fixed-alpha solve: both take the sequential path
    grpl_block = cfg.dic.grplasso and any(
        g_run.layer(c).conv_geometry()["kh"]
        * g_run.layer(c).conv_geometry()["kw"] == 1 for c in g_run.convs)
    pipelined = False
    if (not no_pipeline and roll is not None and cfg.solve.fused_search
            and not grpl_block and not cfg.solve.autodet
            and (channel_targets or input_targets)):
        try:
            _pipelined_conv_pass(
                g_run, p_run, dev_run, cache, cfg, channel_targets, roll,
                record, resume_i, device, input_targets=input_targets,
                residual_compensate=residual_compensate, mesh=mesh)
        except _PipelineDegenerate as exc:
            print(f"[pipeline] {exc}; restarting on the sequential path")
            roll = dev_run = None      # release the frontier before rebuilding
            return solve_prune(graph, params, cache, cfg,
                               channel_targets=channel_targets,
                               input_targets=input_targets,
                               residual_compensate=residual_compensate,
                               device=device, checkpoint=checkpoint,
                               verbose=verbose, mesh=mesh, _no_pipeline=True)
        pipelined = True

    items = [] if pipelined else _layer_items(g_run, p_run, channel_targets,
                                              input_targets, resume_i)
    for i, consumer, bottom, target, gate_only in items:
        n_in = p_run[consumer]["W"].shape[1]
        t0 = time.perf_counter()
        X = _patches(roll, g_run, dev_run, cache, consumer, device, chunk,
                     frontier_fallbacks, cdt, mesh)
        b2 = torch.as_tensor(np.asarray(p_run[consumer].get(
            "b", np.zeros(p_run[consumer]["W"].shape[0], np.float32)),
            np.float32), device=device)
        t, others = _layer_target(g_run, cache, consumer, residual_compensate)
        if others:
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
                           device=device, chunk_batches=chunk,
                           compute_dtype=cdt, mesh=mesh).items()}
        Y = _ground_truth(feats_dev, cache, t, device) - b2
        for o in others:
            Y = Y - cur[o]
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
            fused=cfg.solve.fused_search, autodet=cfg.solve.autodet,
            layeralpha=cfg.dic.layeralpha, mesh=mesh)
        t_end = time.perf_counter()
        record(i, consumer, res, _scatter_inputs(res.W, res.keep), n_in,
               target, gate_only,
               f"= replay {t_solve - t0:.2f} + solve {t_end - t_solve:.2f}",
               seconds=t_end - t0, replay_seconds=t_solve - t0,
               solve_seconds=t_end - t_solve)
        dev_run[consumer] = params_to_torch({consumer: p_run[consumer]},
                                            device)[consumer]
    if checkpoint is not None:
        checkpoint.clear()
    if fitfc:
        g_out, p_out = _fitfc_pass(g_run, p_run, dev_run, g_out, p_out,
                                   selections, reports, cache, cfg,
                                   channel_targets, device, chunk, verbose,
                                   mesh)
    return SolveResult(graph=g_out, params=p_out, reports=reports,
                       selections=selections,
                       frontier_fallbacks=frontier_fallbacks,
                       pipelined=pipelined)


def _fitfc_pass(g_run: Graph, p_run, dev_run, g_out: Graph, p_out,
                selections, reports, cache: sampling.FrozenCache, cfg: Config,
                channel_targets, device, chunk: int, verbose: bool,
                mesh=None):
    """fitfc (the reference's dic.fitfc): prune the last conv's outputs
    through the first FC layer's inputs. The FC's input is captured densely
    (one row per image) from the pruned running net, its weight is viewed
    channel-major (out, C, H, W), and `select_and_reconstruct(group=True)`
    selects C's channels (the group lasso when H·W == 1, the single-task
    search otherwise) and refits the FC on all images. The producer conv
    shrinks and the FC's weight columns are sliced to match."""
    for fc in g_run.fcs:
        bottom = g_run.layer(fc).bottoms[0]
        producer = prune_mod.producer_conv(g_run, bottom)
        target = channel_targets.get(producer) if producer else None
        if target is None:
            continue
        t0 = time.perf_counter()
        dense = sampling.sample_dense(g_run, dev_run, cache.inputs, (bottom,),
                                      device=device, chunk_batches=chunk,
                                      mesh=mesh)[bottom]
        Wfc = np.asarray(p_run[fc]["W"], np.float32)
        n_in = dense.shape[1]
        Wr = Wfc.reshape(Wfc.shape[0], n_in, *dense.shape[2:])
        if target >= n_in:
            continue
        bfc = np.asarray(p_run[fc].get("b", np.zeros(Wfc.shape[0])),
                         np.float32)
        Y = torch.as_tensor(np.asarray(cache.feats[g_run.layer(fc).tops[0]],
                                       np.float32) - bfc).to(device)
        t_solve = time.perf_counter()
        res = prune_mod.select_and_reconstruct(
            dense, Wr, Y, int(target), rank_tol=cfg.dic.rank_tol,
            alpha0=cfg.solve.alpha, subsample=cfg.lasso.subsample_rows,
            n_sweeps=cfg.lasso.n_sweeps, grid_size=cfg.lasso.grid_size,
            max_rounds=cfg.lasso.max_rounds, ridge=cfg.solve.ls_ridge,
            seed=cfg.sample.seed, group=True, prefer=cfg.solve.band,
            mesh=mesh)
        t_end = time.perf_counter()
        # running graph: zero-scatter back into the flat FC weight
        p_run[fc] = {"W": _scatter_inputs(res.W, res.keep).reshape(Wfc.shape),
                     "b": res.b}
        dev_run[fc] = params_to_torch({fc: p_run[fc]}, device)[fc]
        # output graph: shrink the producer conv and slice the FC weight
        if producer is not None and prune_mod._sole_consumer_chain(
                g_out, producer, fc):
            g_out, p_out = rewrite.prune_conv_outputs(g_out, p_out, producer,
                                                      res.keep)
            p_out[fc] = dict(p_out[fc])
            p_out[fc]["W"] = res.W.reshape(Wfc.shape[0], -1)
            p_out[fc]["b"] = res.b
        selections[fc] = res.keep
        reports.append(LayerReport(
            conv=fc, target=int(target), kept=int(res.keep.sum()),
            total=int(n_in), alpha=res.alpha, rmse_before=res.rmse_before,
            rmse_after=res.rmse_after, seconds=t_end - t0,
            replay_seconds=t_solve - t0, solve_seconds=t_end - t_solve,
            kind="fc"))
        if verbose:
            print(f"[fitfc] {fc}: keep {int(res.keep.sum())}/{n_in} rMSE "
                  f"{res.rmse_before:.4f}->{res.rmse_after:.4f} "
                  f"({t_end - t0:.2f}s = dense capture {t_solve - t0:.2f} + "
                  f"solve {t_end - t_solve:.2f})", flush=True)
        break  # only the first FC consumes conv channels
    return g_out, p_out


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
             *, device, checkpoint=None, verbose: bool = True,
             mesh=None) -> SolveResult:
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
    the write in flight before it propagates.

    Under a `mesh` of more than one shard (its lead in place of `device`)
    the frontier's images are split over the shards and the arms' Gram and
    normal equations are row-sharded; X is gathered on the lead for the VH
    refit and the ITQ loop, iterative solvers that a row-sharded sum would
    send elsewhere (in the JAX package an arm flipped)."""
    try:
        return _solve_3c(graph, params, cache, cfg, ranks, skip, device,
                         checkpoint, verbose, mesh)
    except BaseException:
        if checkpoint is not None:
            checkpoint.wait()
        raise


def _solve_3c(graph, params, cache, cfg, ranks, skip, device, checkpoint,
              verbose, mesh) -> SolveResult:
    check_supported(graph, cfg)
    device, mesh = _lead(device, mesh)
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
    cdt = _replay_dtype(cfg)
    roll = _maybe_rolling(g_run, cache, device, cdt, mesh=mesh)

    def patches(conv: str) -> torch.Tensor:
        """X on the lead device, whole (the frontier gathers its rows)."""
        return _patches(roll, g_run, dev_run, cache, conv, device, chunk,
                        frontier_fallbacks, cdt, mesh)

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
                prefer=cfg.solve.band, fused=cfg.solve.fused_search,
                autodet=cfg.solve.autodet, layeralpha=cfg.dic.layeralpha,
                mesh=mesh)
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
