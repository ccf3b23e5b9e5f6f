"""The check comes out false where it must: for the control (the
reference in the program's place in the next lower precision) and for
each fault a prune cell can have, planted in the program under a run that
skips only the harness's look for a card. A sound run of the same tiny
cells comes out true. Tiny cells on the CPU; the limits are theirs
(conftest.TINY_LIMITS)."""
import collections
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from port_bench import checks, harness, job


def _judge(cell, control=False, seed=3):
    prog = job.Program(cell.config, cell.traffic, "cpu")
    orig, params, sets, held = harness.make_inputs(cell, prog, seed, "cpu", 1)
    res = prog.run(params, sets[0], job.Spans(), job=0)
    j = checks.judge(orig, params, sets[0], held, cell.config, cell.traffic,
                     harness.job_settings(prog), job.plain_layers(res.graph),
                     res.params, res.selections, res.cache.feats, res.cache.plan,
                    harness.report_alphas(res.reports),
                     "cpu", control=control)
    return checks.verdict(j["numbers"], cell.limits)


@pytest.mark.parametrize("name", ["tvgg.tcp", "tres.trcp", "txc.txcp"])
def test_sound_run_passes_and_control_fails(tiny_root, name):
    cell = harness.load_cell(tiny_root, name)
    assert _judge(cell)[0]
    ok, rows = _judge(cell, control=True)
    assert not ok
    # the control fails both numbers it takes the program's place in
    assert rows["freeze_gap"]["value"] > rows["freeze_gap"]["limit"]
    assert rows["refit_excess"]["value"] > rows["refit_excess"]["limit"]


def _state_unchanged(monkeypatch):
    """The layer solve hands back the layer's weights unchanged, masked."""
    from channel_pruning_tpu_torch.pipeline import prune
    real = prune._fused_layer_solve

    def fake(Xd, W2d, *a, **k):
        out = real(Xd, W2d, *a, **k)
        c = W2d.shape[1]
        mask = out.mask.reshape(1, c, 1, 1).to(W2d.dtype)
        return out._replace(Wfull=W2d * mask, b=torch.zeros_like(out.b))
    monkeypatch.setattr(prune, "_fused_layer_solve", fake)


def _half_the_rows(monkeypatch):
    """The refit sums over half the rows, its means over the rest."""
    from channel_pruning_tpu_torch.ops import lstsq
    real = lstsq.fit_linear

    def fake(X, Y, *a, **k):
        n = X.shape[0] // 2
        return real(X[:n], Y[:n], *a, **k)
    monkeypatch.setattr(lstsq, "fit_linear", fake)


def _answer_altered(monkeypatch):
    """Each layer's reconstruction is scaled by 1.1 where the solve
    produces it."""
    from channel_pruning_tpu_torch.pipeline import prune
    real = prune._fused_layer_solve

    def fake(*a, **k):
        out = real(*a, **k)
        return out._replace(Wfull=out.Wfull * 1.1)
    monkeypatch.setattr(prune, "_fused_layer_solve", fake)


def _ground_truth_altered(monkeypatch):
    """One frozen ground-truth row is changed where the freeze produces it."""
    from channel_pruning_tpu_torch.sampling import sampler
    real = sampler.sample_features

    def fake(*a, **k):
        feats = real(*a, **k)
        t = next(iter(feats))
        feats[t] = feats[t].copy()
        feats[t][0] *= 1.01
        return feats
    monkeypatch.setattr(sampler, "sample_features", fake)


def _selection_by_weight_norm(monkeypatch):
    """Each layer keeps as many channels as its search found, but the ones
    whose weights have the largest norm, and refits to them."""
    from channel_pruning_tpu_torch.ops import lstsq
    from channel_pruning_tpu_torch.pipeline import prune
    real = prune._fused_layer_solve

    def fake(Xd, W2d, Yd, *a, **k):
        out = real(Xd, W2d, Yd, *a, **k)
        c = W2d.shape[1]
        norms = W2d.transpose(0, 1).reshape(c, -1).norm(dim=1)
        mask = torch.zeros(c, dtype=torch.bool)
        mask[torch.topk(norms, int(out.mask.sum())).indices] = True
        cols = mask[:, None].expand(c, Xd.shape[2] * Xd.shape[3]).reshape(-1)
        W, b = lstsq.fit_linear(Xd.reshape(Xd.shape[0], -1) * cols.to(Xd.dtype),
                                Yd, ridge=a[-1])
        return out._replace(mask=mask, Wfull=W.reshape(W2d.shape), b=b)
    monkeypatch.setattr(prune, "_fused_layer_solve", fake)


def _measure(tiny_root, capsys, name):
    """The result line of a whole run of cell `name` on the CPU: its seed
    puts the judged set first in the pool's cycle, so that the window holds
    one job."""
    cell = harness.load_cell(tiny_root, name)
    args = types.SimpleNamespace(workload=name, seed=2 ** 31 + 12, seconds=0.0,
                                 trace=0)
    assert harness.measure(cell, args, torch.device("cpu"), 0.0) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_rows,
                                   _answer_altered, _ground_truth_altered,
                                   _selection_by_weight_norm])
@pytest.mark.parametrize("name", ["tvgg.tcp", "tres.trcp", "txc.txcp"])
def test_each_fault_makes_a_run_incorrect(tiny_root, monkeypatch, capsys,
                                          fault, name):
    fault(monkeypatch)
    result = _measure(tiny_root, capsys, name)
    assert result["correct"] is False
    assert result["failed"] == 1


# the gate of Xception's exit flow: a Select in front of exit_sep3_dw
GATED_THROUGH_DEPTHWISE = ("exit_sep3_pw",)


def depthwise_on_other_channels(monkeypatch, consumers=GATED_THROUGH_DEPTHWISE):
    """The model of each gate in `consumers` keeps the channels of its
    search's selection rolled by one: its Select and the depthwise conv
    behind it pass those, and the consumer is refit to them and runs so in
    the running net (every later layer is fit to the model as built); the
    job reports the search's own selection."""
    from channel_pruning_tpu_torch.ops import lstsq
    from channel_pruning_tpu_torch.pipeline import c3, prune
    real_items, real_solve = c3._layer_items, prune._fused_layer_solve
    real_apply = prune.apply_pruning
    order, built = collections.deque(), collections.deque()

    def items(*a, **k):
        got = real_items(*a, **k)
        order.extend(it[1] for it in got)
        return got

    def solve(Xd, W2d, Yd, *a, **k):
        out = real_solve(Xd, W2d, Yd, *a, **k)
        if order.popleft() not in consumers:
            built.append(None)
            return out
        c = W2d.shape[1]
        keep = torch.roll(out.mask, 1)
        cols = keep[:, None].expand(c, Xd.shape[2] * Xd.shape[3]).reshape(-1)
        W, b = lstsq.fit_linear(Xd.reshape(Xd.shape[0], -1) * cols.to(Xd.dtype),
                                Yd, ridge=a[-1])
        W = W.reshape(W2d.shape)
        built.append((keep.cpu().numpy(), W[:, keep].cpu().numpy(),
                      b.cpu().numpy()))
        return out._replace(Wfull=W, b=b)

    def apply(g, p, consumer, res, shrink_producer=True):
        model = built.popleft()
        if model is not None:
            keep, W, b = model
            res = dataclasses.replace(res, keep=keep, W=W, b=b)
        return real_apply(g, p, consumer, res, shrink_producer)

    monkeypatch.setattr(c3, "_layer_items", items)
    monkeypatch.setattr(prune, "_fused_layer_solve", solve)
    monkeypatch.setattr(prune, "apply_pruning", apply)


def gate_in_place_of_shrink(monkeypatch):
    """A depthwise chain whose producer should shrink keeps its width: a
    Select goes in front of the depthwise conv instead."""
    from channel_pruning_tpu_torch.pipeline import prune
    real = prune._sole_consumer_chain

    def sole(graph, prod, consumer):
        if graph.layer(consumer).conv_geometry()["group"] > 1:
            return False
        return real(graph, prod, consumer)
    monkeypatch.setattr(prune, "_sole_consumer_chain", sole)


@pytest.mark.parametrize("fault, name, caught_by", [
    # with no solved layer after the gate, only depthwise_off sees it
    (depthwise_on_other_channels, "txc.txcp3", {"depthwise_off"}),
    # exit_sep4_pw's search, rebuilt on the selection the job reports, sees
    # it too
    (depthwise_on_other_channels, "txc.txcp", {"depthwise_off", "select_off"}),
    # counts off: the selections and refits are not judged (inf)
    (gate_in_place_of_shrink, "txc.txcp",
     {"counts_off", "select_off", "refit_excess"}),
])
def test_each_depthwise_fault_makes_a_run_incorrect(tiny_root, monkeypatch, capsys,
                                                    fault, name, caught_by):
    fault(monkeypatch)
    result = _measure(tiny_root, capsys, name)
    assert result["correct"] is False
    failed = {n for n, r in result["checks"].items()
              if r["value"] is None or r["value"] > r["limit"]}
    assert failed == caught_by
