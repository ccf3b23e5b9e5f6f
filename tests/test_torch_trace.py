"""The port's tracer (utils/trace) and its spans and counters in the
compression job: the off path records nothing, creates no event and
passes the CD kernels no `stats`; nested spans carry their parents, self
times, layers and jobs; the device clock comes from the events through
the anchor; a traced `solve_prune` on the tiny VGG and ResNet gives each
solved layer every span of the pass and the same answer bit for bit as an
untraced one; `cd.sweeps` is the plain CD's sweeps over the live alphas;
and the traced-run readers of tools/trace_cell.py on hand-built spans and
operations; the depthwise convs' spans and the shrink and gate counters
of a depthwise-separable net, and the widths whose CD launches count as
bounds-tested. Imports only the port."""
import importlib.util
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from channel_pruning_tpu_torch.convert import params_to_torch
from channel_pruning_tpu_torch.kernels import lasso_cd
from channel_pruning_tpu_torch.models.resnet import build_tiny_resnet
from channel_pruning_tpu_torch.models.vgg import build_tiny_vgg
from channel_pruning_tpu_torch.models.xception import build_tiny_xception
from channel_pruning_tpu_torch.ops import lasso
from channel_pruning_tpu_torch.ops.forward import run_graph
from channel_pruning_tpu_torch.pipeline import c3, prune
from channel_pruning_tpu_torch.sampling import sampler
from channel_pruning_tpu_torch.utils import trace
from channel_pruning_tpu_torch.utils.config import default_config
from torch_cpu import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def tracing_off():
    trace.enable()              # clears the records of earlier tests
    trace.disable()
    trace.set_job(None)
    yield
    trace.disable()
    trace.set_job(None)


def _net(kind):
    if kind == "vgg":
        g, p = build_tiny_vgg(batch=4, image_size=16)
        shape, share, targets = (8, 4, 3, 16, 16), None, (
            {"conv1_1": 5, "conv1_2": 6, "conv2_1": 8}, None)
    else:
        g, p = build_tiny_resnet(batch=4, image_size=32)
        shape, share = (8, 4, 3, 32, 32), sampler.resnet_share_key
        g, p = c3.preprocess(g, p)
        ct, it = {}, {}
        for conv in g.convs:
            n = int(g.layer(conv).attr("num_output"))
            if conv.endswith(("branch2a", "branch2b")):
                ct[conv] = max(2, int(n * 0.7))
            if conv.endswith("branch2a"):
                it[conv] = max(2, int(p[conv]["W"].shape[1] * 0.7))
        targets = (ct, it)
    if kind == "vgg":
        g, p = c3.preprocess(g, p)
    inputs = np.random.default_rng(7).normal(0, 1, shape).astype(np.float32)
    cache = sampler.freeze(g, params_to_torch(p, "cpu"), inputs, device="cpu",
                           n_points=8, seed=0, chunk_batches=4,
                           share_key=share(g) if share else None)
    return g, p, cache, targets


@pytest.fixture(scope="module", params=["vgg", "resnet"])
def net(request):
    return (request.param,) + _net(request.param)


def _solve(g, p, cache, targets):
    cfg = default_config().replace_nested("solve.band", "bottom")
    return c3.solve_prune(g, p, cache, cfg, channel_targets=targets[0],
                          input_targets=targets[1], device="cpu",
                          verbose=False)


class _FakeEvent:
    """A CUDA event on the CPU: its device clock is the host clock at
    another origin and, for the anchors to correct, another rate."""
    made = 0
    OFFSET = 123.0
    RATE = 1.5

    def __init__(self):
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = self.RATE * time.perf_counter() + self.OFFSET

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


@pytest.fixture
def fake_card(monkeypatch):
    """The tracer's CUDA calls replaced, so that its device path runs on
    the CPU; the kernels' `stats` argument recorded."""
    _FakeEvent.made = 0
    monkeypatch.setattr(trace, "_event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **kw: None)
    seen = []
    real = lasso_cd.cd_solve_grid

    def spy(G, b, a_n, **kw):
        seen.append(kw.get("stats"))
        return real(G, b, a_n, **kw)

    monkeypatch.setattr(lasso_cd, "cd_solve_grid", spy)
    return seen


def test_off_path_records_nothing(net, fake_card):
    """Tracing off (the default): the pass records no span, makes no event
    and passes the kernels no `stats`; `span()` is one shared context and
    `count()` adds nothing."""
    _, g, p, cache, targets = net
    assert trace.span("a") is trace.span("b", layer="c")
    trace.count("cd.sweeps", 5)
    res = _solve(g, p, cache, targets)
    assert res.pipelined
    assert fake_card and all(s is None for s in fake_card)
    assert _FakeEvent.made == 0
    assert trace.records() == []
    assert "cd.sweeps" not in trace.counters()
    # the same pass traced on the fake card makes events and passes stats
    trace.enable(torch.device("cuda"))
    _solve(g, p, cache, targets)
    trace.disable()
    assert _FakeEvent.made > 0
    assert all(s is not None for s in fake_card[-3:])


def test_nested_spans_parents_self_times_and_jobs():
    trace.enable()
    trace.set_job(4)
    with trace.span("outer", layer="conv2_1"):
        time.sleep(0.02)
        with trace.span("inner"):
            time.sleep(0.03)
        with trace.span("other", layer="conv3_1"):
            pass
    trace.set_job(5)
    with trace.span("next"):
        trace.count("x", 2)
        trace.count("x", 3)
    trace.disable()
    with trace.span("after"):
        pass
    spans = trace.records()
    assert [s.name for s in spans] == ["outer", "inner", "other", "next"]
    outer, inner, other, nxt = spans
    assert (outer.parent, inner.parent, other.parent, nxt.parent) == \
        (None, 0, 0, None)
    assert (inner.layer, other.layer, nxt.layer) == ("conv2_1", "conv3_1", None)
    assert [s.job for s in spans] == [4, 4, 4, 5]
    assert outer.self_s == pytest.approx(
        outer.host_s - inner.host_s - other.host_s)
    assert outer.self_s >= 0.02 and inner.self_s >= 0.03
    assert all(s.dev_start is None for s in spans)     # no card
    assert trace.counters()["x"] == 5
    trace.enable()                                     # a new window
    assert trace.records() == [] and "x" not in trace.counters()


def test_counters_give_the_launches_since_enable(monkeypatch):
    monkeypatch.setattr(lasso_cd, "LAUNCHES", 10)
    trace.enable()
    monkeypatch.setattr(lasso_cd, "LAUNCHES", 17)
    monkeypatch.setattr(lasso_cd, "LAUNCHES_SPLIT", 5)
    monkeypatch.setattr(lasso_cd, "queue_stalls", lambda: 2)
    assert trace.counters()["cd.k1_launches"] == 7
    assert trace.counters()["cd.k2_launches"] == 0
    assert trace.counters()["cd.split_launches"] == 5
    assert trace.counters()["cd.queue_stalls"] == 2


def test_device_times_on_the_host_clock(fake_card):
    """Events at entry and exit, put on the host clock through the anchors
    of `enable` and `disable`: the card's clock origin and rate drop out,
    device times follow host times."""
    trace.enable(torch.device("cuda"))
    with trace.span("a"):
        time.sleep(0.01)
        with trace.span("b"):
            time.sleep(0.01)
    trace.disable()
    a, b = trace.records()
    assert _FakeEvent.made == 6                # two anchors and two a span
    for s in (a, b):
        assert s.dev_start == pytest.approx(s.host_start, abs=1e-3)
        assert s.dev_end == pytest.approx(s.host_end, abs=1e-3)
    assert a.dev_start <= b.dev_start <= b.dev_end <= a.dev_end
    assert a.dev_s >= 0.02


def test_traced_solve_is_bit_identical_with_every_span(net):
    """A traced solve gives each solved layer each span of the pass once,
    inside `pass`, with `solve.*` inside `pass.solve`; its selections and
    parameters equal an untraced solve's bit for bit; and the live alphas
    are the grids the searches solved."""
    kind, g, p, cache, targets = net
    base = _solve(g, p, cache, targets)
    trace.enable()
    trace.set_job(0)
    res = _solve(g, p, cache, targets)
    trace.disable()
    spans = trace.records()
    assert spans[0].name == "pass" and spans[0].parent is None
    assert all(s.job == 0 for s in spans)
    layers = [r.conv for r in res.reports]
    for conv in layers:
        mine = [s for s in spans if s.layer == conv]
        assert sorted(s.name for s in mine) == sorted(c3.PASS_SPANS), conv
        for s in mine:
            want = "pass.solve" if s.name.startswith("solve.") else "pass"
            assert spans[s.parent].name == want, (conv, s.name)
    assert sum(s.name == "pass.upload" for s in spans) == 2
    assert set(res.selections) == set(base.selections)
    for name in base.selections:
        np.testing.assert_array_equal(res.selections[name],
                                      base.selections[name])
    assert set(res.params) == set(base.params)
    for name in base.params:
        for k in base.params[name]:
            np.testing.assert_array_equal(res.params[name][k],
                                          base.params[name][k])
    counts = trace.counters()
    grid = default_config().lasso.grid_size
    assert counts["cd.live_alphas"] == grid * sum(r.grids for r in res.reports)
    assert counts["cd.live_alphas"] <= counts["cd.sweeps"] <= \
        counts["cd.live_alphas"] * default_config().lasso.n_sweeps
    assert 0 < counts["cd.moves"]


def test_freeze_and_preprocess_spans():
    g, p = build_tiny_vgg(batch=4, image_size=16)
    inputs = np.random.default_rng(3).normal(0, 1, (8, 4, 3, 16, 16)) \
        .astype(np.float32)
    trace.enable()
    g, p = c3.preprocess(g, p)
    sampler.freeze(g, params_to_torch(p, "cpu"), inputs, device="cpu",
                   n_points=4, seed=0, chunk_batches=4)
    trace.disable()
    spans = trace.records()
    names = [s.name for s in spans]
    assert names == ["preprocess", "preprocess.merge_bn",
                     "preprocess.split_relu", "freeze",
                     "freeze.upload", "freeze.forward",
                     "freeze.upload", "freeze.forward", "freeze.to_host"]
    assert [s.parent for s in spans] == [None, 0, 0, None, 3, 3, 3, 3, 3]


def test_cd_sweeps_are_the_plain_stats_over_live_alphas(monkeypatch):
    """`cd.sweeps`, `cd.live_alphas` and `cd.moves` of a search equal the
    plain CD's own `stats` summed over the alphas that were not +inf,
    round by round, and the rounds after the search ended count nothing."""
    rng = np.random.default_rng(5)
    Z = torch.from_numpy(rng.normal(size=(900, 40)).astype(np.float32))
    gram = lasso.lasso_gram(Z, Z[:, :12].sum(dim=1)
                            + 0.1 * torch.from_numpy(
                                rng.normal(size=900).astype(np.float32)))
    grids = []
    real = lasso_cd.cd_solve_grid

    def spy(G, b, a_n, **kw):
        grids.append(a_n.clone())
        return real(G, b, a_n, **kw)

    monkeypatch.setattr(lasso_cd, "cd_solve_grid", spy)
    trace.enable()
    lasso.fused_search_alpha(gram, 10, 0.1, max_rounds=8, prefer="bottom")
    counts = trace.counters()
    trace.disable()
    sweeps = live = moves = 0
    for a_n in grids:
        stats = torch.zeros((a_n.shape[0], 2), dtype=torch.int32)
        lasso_cd.cd_solve_grid_plain(gram.G, gram.b, a_n, stats=stats)
        ok = torch.isfinite(a_n)
        sweeps += int(stats[ok, 0].sum())
        moves += int(stats[ok, 1].sum())
        live += int(ok.sum())
    assert len(grids) == 8 and live < 8 * grids[0].shape[0]  # it ended early
    assert moves > sweeps
    assert (counts["cd.sweeps"], counts["cd.live_alphas"],
            counts["cd.moves"]) == (sweeps, live, moves)


def test_layer_table_lines():
    trace.enable()
    for layer in ("c1", "c2"):
        with trace.span("pass.solve", layer):
            with trace.span("solve.search"):
                pass
    trace.disable()
    lines = trace.layer_table(trace.records(), ("pass.solve", "solve.search"),
                              "t")
    assert [l.split(":")[0] for l in lines] == ["[t] c1", "[t] c2",
                                                "[t] totals over 2 layers"]
    assert all("pass.solve host " in l and "solve.search host " in l
               and "dev -" in l for l in lines)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "trace_cell", REPO / "tools" / "trace_cell.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(name, job, h0, h1, d0, d1, layer=None):
    return trace.Span(name=name, layer=layer, job=job, parent=None,
                      host_start=h0, host_end=h1, dev_start=d0, dev_end=d1,
                      self_s=h1 - h0)


def test_trace_cell_readers_on_hand_built_spans():
    """The readers of tools/trace_cell.py: device busy is the union of
    operations clipped to the named spans' device extents, a job each;
    host ms of `pass.drain_wait`; the clock checks; gaps named by the
    innermost span open on the host."""
    tool = _tool()
    spans = [
        _span("pass.advance", 0, 0.0, 1.0, 0.5, 2.0, "c1"),
        _span("solve.search", 0, 1.0, 2.0, 2.0, 4.0, "c1"),
        _span("pass.drain_wait", 0, 2.0, 2.5, 4.0, 4.0, "c1"),
        _span("pass.advance", 1, 5.0, 6.0, 5.5, 6.5, "c1"),
        _span("solve.search", 1, 6.0, 9.0, 6.5, 8.0, "c1"),
        _span("pass.drain_wait", 1, 9.0, 9.25, 9.0, 9.0, "c1"),
    ]
    ops = [("conv", 0.0, 1.0), ("conv", 0.8, 1.5), ("lasso_cd", 2.5, 3.0),
           ("lasso_cd", 2.9, 3.5), ("conv", 5.0, 6.0), ("lasso_cd", 7.0, 9.0)]
    # pass.advance: [0.5, 1.5] of job 0 and [5.5, 6.0] of job 1
    assert tool.busy_ms(spans, ("pass.advance",), ops, 2) == \
        pytest.approx(1e3 * 1.5 / 2)
    # solve.search: [2.5, 3.5] and [7.0, 8.0]
    assert tool.busy_ms(spans, ("solve.search",), ops, 2) == \
        pytest.approx(1e3 * 2.0 / 2)
    assert tool.host_ms(spans, ("pass.drain_wait",), 2) == \
        pytest.approx(1e3 * 0.75 / 2)
    assert tool.ops_in(spans, "solve.search", ops) == [["lasso_cd", 2.0]]
    harness = [("prune_pass", 0, 0.0, 4.5), ("prune_pass", 1, 5.0, 9.1)]
    chk = tool.clock_checks(spans, harness, [0, 1])
    assert chk == {"spans_timed": 6, "dev_after_host_share": 1.0,
                   "pass_overlaps": 0, "pass_outside_prune_pass": 0}
    # a span that starts on the device before the host, overlaps the
    # others of its job and ends after the job's prune_pass
    late = spans + [_span("pass.bookkeep", 1, 9.3, 9.4, 6.2, 9.2)]
    chk = tool.clock_checks(late, harness, [0, 1])
    assert chk["pass_overlaps"] == 2 and chk["pass_outside_prune_pass"] == 1
    assert chk["dev_after_host_share"] == pytest.approx(6 / 7)

    class Trace:
        def idle_gaps(self):
            return [(4.6, 5.0), (1.5, 1.6), (9.5, 9.55)]

    outer = _span("pass", 0, 0.0, 4.4, 0.0, 4.4)
    gaps = tool.named_gaps(Trace(), harness, [outer] + spans, {0, 1}, n=2)
    assert gaps == [["between spans", pytest.approx(0.4)],
                    ["prune_pass (job 0) / solve.search c1",
                     pytest.approx(0.1)]]
    rows = tool.job_split(spans, ops, [0, 1], [4.5, 4.0])
    assert rows[0]["solve.search"] == pytest.approx([1e3, 1e3])
    assert rows[1]["pass.advance"] == pytest.approx([1e3, 500])
    assert rows[1]["pass.drain_wait"] == pytest.approx([250, 0])
    assert tool.lead_ms(spans) == pytest.approx([0, 0, 500])


@pytest.fixture(scope="module")
def tiny_xception():
    g, p = build_tiny_xception(batch=2, image_size=32)
    return c3.preprocess(g, p)


def _depthwise_convs(g):
    return [c for c in g.convs if g.layer(c).conv_geometry()["group"] > 1]


def test_depthwise_convs_run_in_their_own_spans(tiny_xception):
    """A traced CPU forward of the tiny Xception opens one
    `forward.depthwise` span a depthwise conv, named after it, in the
    order the convs run, and none for a group-1 conv; off, none."""
    g, p = tiny_xception
    x = {"data": torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (2, 3, 32, 32)).astype(np.float32))}
    dws = _depthwise_convs(g)
    assert len(dws) == 16 and len(g.convs) > len(dws)     # 2 middle blocks
    run_graph(g, params_to_torch(p, "cpu"), x)
    assert trace.records() == []
    trace.enable()
    run_graph(g, params_to_torch(p, "cpu"), x)
    trace.disable()
    spans = trace.records()
    assert [s.name for s in spans] == ["forward.depthwise"] * len(dws)
    assert [s.layer for s in spans] == dws
    assert all(s.host_s >= 0 for s in spans)


def _prune_once(g, p, consumer):
    """`apply_pruning` on `consumer` keeping every other input channel,
    traced; the counters it added."""
    c_in = p[consumer]["W"].shape[1]
    keep = np.arange(c_in) % 2 == 0
    W = p[consumer]["W"][:, keep]
    res = prune.PruneResult(keep=keep, W=W, b=p[consumer]["b"], alpha=0.0,
                            rmse_before=0.0, rmse_after=0.0)
    trace.enable()
    g2, _ = prune.apply_pruning(g, p, consumer, res)
    trace.disable()
    return g2, trace.counters()


PRUNE_COUNTERS = ("prune.shrinks", "prune.gates", "prune.dw_shrinks",
                  "prune.dw_gates")


@pytest.mark.parametrize("consumer,want", [
    # its chain starts at a residual sum: the depthwise conv shrinks and a
    # Select goes in front of it
    ("mid1_sep1_pw", {"prune.gates": 1, "prune.dw_shrinks": 1,
                      "prune.dw_gates": 1}),
    # the chain's top is a pointwise conv: it shrinks with the depthwise one
    ("mid1_sep2_pw", {"prune.shrinks": 1, "prune.dw_shrinks": 1}),
    ("exit_sep4_pw", {"prune.shrinks": 1, "prune.dw_shrinks": 1}),
])
def test_shrinks_and_gates_are_counted(tiny_xception, consumer, want):
    g, p = tiny_xception
    g2, counts = _prune_once(g, p, consumer)
    assert {k: counts[k] for k in PRUNE_COUNTERS if k in counts} == want
    dw = consumer[:-3] + "_dw"
    half = (p[consumer]["W"].shape[1] + 1) // 2
    assert int(g2.layer(dw).attr("num_output")) == half
    gates = [l for l in g2.layers if l.type == "Select"]
    assert len(gates) == want.get("prune.gates", 0)
    if gates:
        assert gates[0].tops[0] in g2.layer(dw).bottoms


def test_prune_counters_are_off_with_the_tracer(tiny_xception):
    g, p = tiny_xception
    _prune_once(g, p, "mid1_sep1_pw")
    trace.enable()
    trace.disable()
    c_in = p["mid1_sep2_pw"]["W"].shape[1]
    keep = np.ones(c_in, bool)
    keep[0] = False
    res = prune.PruneResult(keep=keep, W=p["mid1_sep2_pw"]["W"][:, keep],
                            b=p["mid1_sep2_pw"]["b"], alpha=0.0,
                            rmse_before=0.0, rmse_after=0.0)
    prune.apply_pruning(g, p, "mid1_sep2_pw", res)
    assert not set(PRUNE_COUNTERS) & set(trace.counters())


def _dispatch(entry: str) -> list[tuple[int | None, str, tuple[int, ...]]]:
    """(chunk bound or None for the last `else`, launcher, template
    arguments) of each branch of an entry point of csrc/lasso_cd.cu."""
    src = (REPO / "channel_pruning_tpu_torch" / "csrc" / "lasso_cd.cu").read_text()
    body = src[src.index(f"int {entry}("):]
    body = body[:body.index("\n}\n")]
    return [(int(bound) if bound else None, kind,
             tuple(int(a) for a in re.findall(r"\d+", args)))
            for bound, kind, args in re.findall(
                r"(?:if \(chunks <= (\d+)\)|else)\s*err = launch_(\w+)<([^>]*)>",
                body)]


def test_split_instances_are_the_sources_dispatch():
    """`cd.split_launches` counts every K1/K2 launch because every branch
    of each entry point's dispatch in csrc/lasso_cd.cu launches a split
    instance, from one chunk up, and each instance is wide enough for its
    class: 32·M·(update warps) covers the branch's chunks, the last branch
    the entry's largest c."""
    for entry, top in (("cp_lasso_cd_grid", lasso_cd.MAX_C),
                       ("cp_lasso_cd_grid_stream", lasso_cd.MAX_C_STREAM)):
        branches = _dispatch(entry)
        assert branches and branches[-1][0] is None, entry
        assert [bound for bound, _, _ in branches[:-1]] == sorted(
            bound for bound, _, _ in branches[:-1]), entry
        for bound, kind, (m, nw, _r, _s) in branches:
            assert kind == "split", (entry, bound)
            chunks = bound if bound is not None else top // 32
            assert m * (nw - nw // 4) >= chunks, (entry, bound)


def test_trace_cell_launch_and_prune_readings():
    tool = _tool()
    counts = {"cd.k1_launches": 270, "cd.k2_launches": 10,
              "cd.split_launches": 56,
              "cd.moves": 4000, "cd.queue_stalls": 12, "prune.shrinks": 60,
              "prune.gates": 30, "prune.dw_shrinks": 68, "prune.dw_gates": 26}
    got = tool.launch_readings(counts, 2)
    assert got == {"cd_split_share": pytest.approx(0.2),
                   "cd_stalls_per_move": pytest.approx(0.003), "shrinks": 30,
                   "gates": 15, "dw_shrinks": 34, "dw_gates": 13}
    empty = tool.launch_readings({}, 3)
    assert empty["cd_split_share"] is None and empty["gates"] == 0
    assert empty["cd_stalls_per_move"] is None


def test_trace_cell_kernel_alignment():
    """Kernels that run 0.3 ms after their spans' recorded extents: half
    their time inside as recorded, all of it at the shift found."""
    tool = _tool()
    spans = [_span("forward.depthwise", 0, t, t + 0.1, t, t + 6e-4, "dw")
             for t in (1.0, 2.0, 3.0)]
    ops = [("conv_depthwise2d_forward_kernel", t + 3e-4, t + 9e-4)
           for t in (1.0, 2.0, 3.0)] + [("implicit_gemm", 1.5, 1.6)]
    got = tool.kernel_alignment(spans, "forward.depthwise", ops,
                                "conv_depthwise2d")
    assert got["share"] == pytest.approx(0.5)
    assert got["best_shift_ms"] == pytest.approx(0.3)
    assert got["share_at_best"] == pytest.approx(1.0)
    assert got["kernels"] == 3
    assert tool.kernel_alignment(spans, "forward.depthwise", ops[3:],
                                 "conv_depthwise2d") is None
