"""The check comes out false where it must: for the control (the
reference in the program's place in the next lower precision) and for
each fault a prune cell can have, planted in the program under a run that
skips only the harness's look for a card. A sound run of the same tiny
cells comes out true. Tiny cells on the CPU; the limits are theirs
(conftest.TINY_LIMITS)."""
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


@pytest.mark.parametrize("name", ["tvgg.tcp", "tres.trcp"])
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


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_rows,
                                   _answer_altered, _ground_truth_altered,
                                   _selection_by_weight_norm])
@pytest.mark.parametrize("name", ["tvgg.tcp", "tres.trcp"])
def test_each_fault_makes_a_run_incorrect(tiny_root, monkeypatch, capsys,
                                          fault, name):
    fault(monkeypatch)
    cell = harness.load_cell(tiny_root, name)
    args = types.SimpleNamespace(workload=name, seed=2 ** 31 + 11, seconds=0.0,
                                 trace=0)
    assert harness.measure(cell, args, torch.device("cpu"), 0.0) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is False
    assert result["failed"] == 1
