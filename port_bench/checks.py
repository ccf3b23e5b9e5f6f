"""What decides `correct`: the program's output of a job, judged against
the plain reference (reference/plain.py) on the inputs the benchmark handed
the program. Nothing here imports the program; its output arrives as plain
layer lists, numpy parameters, its selections and the frozen cache's
arrays.

The layers a job solves follow the program's stated contract
(`c3.solve_prune`: `channel_targets` maps a producer conv to the outputs it
keeps, `input_targets` a consumer conv to the inputs its gate keeps), read
on the original net (`solved_layers`). A depthwise conv (group equal to its
outputs and its input channels) maps channel i to channel i: it passes
channels for the search as a ReLU does, and is never a solved layer. A
solved layer is a group-1 conv, not the first conv, whose input is written
by conv p (a depthwise conv too) through channel-preserving layers, with a
target `channel_targets[p]` (or `input_targets` of the layer) below its
input width. Up from the layer through channel-preserving layers and
depthwise convs to the nearest group-1 conv, the producer:
  - a shrink, where that chain feeds the layer alone: the producer and
    every depthwise conv between lose the dropped channels;
  - otherwise a gate: a Select where the chain stops being the layer's
    alone (in front of the layer for `input_targets`), the depthwise convs
    below it shrunk, the producer at its width.

The numbers, each against the limit of the cell's file under `limits/`:
  freeze_gap    the program's sampled ground truth against the reference's
                own freeze of the original net at its own point plan: the
                largest max|gap| over a tensor's RMS; inf where a tensor or
                the plan differs;
  counts_off    the layers whose kept count leaves the band the traffic
                states, or that are missing: a shrink read from the shrunk
                producer's width, a gate from its Select's indices wherever
                along the chain it sits; exact, limit 0;
  select_off    per solved layer, the share of the k channels the program
                kept that the reference's own LASSO does not keep: the
                reference rebuilds the layer's search problem (Z on the
                job's row subsample, the original weights, the ground truth
                less the bias and the junction's other summands; X the
                layer's input in the job's running net at full width),
                solves it exactly at the alpha the program reports, and
                keeps the k largest |beta|; the largest;
  refit_excess  per solved layer, (J - J_opt) / ||Y - mean(Y)||^2, J the
                refit's objective (squared error plus the job's ridge, a
                jitter times the Gram's trace) at the program's weights
                and J_opt its least value for the same kept channels; X is
                the layer's input in the program's compressed model at the
                layer's planned points, Y the ground truth less the other
                summands of its residual junction as they were when the job
                solved the layer; a producer whose outputs a later layer
                pruned, through depthwise convs or not, judged on the
                outputs kept; the largest;
  depthwise_off per depthwise conv the job shrank or gated, max|W - W_orig|
                over the RMS of W_orig, W_orig its original weights (folded
                with their BatchNorm) at the channels the layer it feeds
                reports, bias included; inf where its width or the gate's
                Select keeps another set; the largest, 0 in a net without
                depthwise convs. It sees a model built from other channels
                than the selection reported, with the refit consistent
                with them, which the other numbers miss where no solved
                layer follows (the refit is judged on the model's own X,
                the selection on the reported mask).
The control is the reference in the program's place in the next lower
precision: its freeze in TF32 (the freeze is f32 in every job), its
searches and refits on inputs rounded to `traffic["control_rounding"]`
(the next precision below the replays'), judged by the same numbers.
"""
from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from port_bench import shapes as shp
from port_bench.reference import plain

_PASS_THROUGH = ("ReLU", "Pooling", "Dropout", "BatchNorm", "Scale")
# The refit's jitter, lam = LSTSQ_JITTER * trace of the centred Gram: the
# job's least squares states it (its default, which no setting changes).
LSTSQ_JITTER = 1e-6


def reference_flags() -> None:
    """f32 convs and matmuls with TF32 off, whatever the program set."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def band(target: int, tol: float) -> tuple[int, int]:
    """The kept counts a target of `target` at rank_tol `tol` accepts."""
    return int(target), int(math.floor(target * (1.0 + tol) + 1e-6))


def _depthwise(l: dict) -> bool:
    """A depthwise conv: one output a group (as `prune.apply_pruning` tells
    one; in the nets here each group also reads one input channel)."""
    a = l["attrs"]
    g = int(a.get("group", 1))
    return l["type"] == "Convolution" and g > 1 and g == int(a["num_output"])


def _group1(l: dict | None) -> bool:
    return l is not None and l["type"] == "Convolution" \
        and int(l["attrs"].get("group", 1)) == 1


def _writer(layers: list[dict], tensor: str, before: int) -> int | None:
    """The index of the last layer before index `before` that writes
    `tensor` (an in-place layer writes its bottom's name)."""
    for i in range(before - 1, -1, -1):
        if tensor in layers[i]["tops"]:
            return i
    return None


def _walk_up(layers: list[dict], consumer: str) -> tuple[list[str], dict | None]:
    """(the depthwise convs between `consumer` and the layer that writes its
    input channels, nearest first; that layer, or None at the input): up
    from the consumer's input through channel-preserving layers and
    depthwise convs."""
    i = next(k for k, l in enumerate(layers) if l["name"] == consumer)
    tensor, dws = layers[i]["bottoms"][0], []
    while True:
        i = _writer(layers, tensor, i)
        if i is None:
            return dws, None
        l = layers[i]
        if _depthwise(l):
            dws.append(l["name"])
        elif l["type"] not in _PASS_THROUGH:
            return dws, l
        tensor = l["bottoms"][0]


def _feeds_only(layers: list[dict], name: str, consumer: str) -> bool:
    """Whether layer `name`'s output reaches no layer but `consumer`
    through channel-preserving layers and depthwise convs."""
    i = next(k for k, l in enumerate(layers) if l["name"] == name)
    want = set(layers[i]["tops"])
    for l in layers[i + 1:]:
        if l["name"] == consumer or not set(l["bottoms"]) & want:
            continue
        if l["type"] not in _PASS_THROUGH and not _depthwise(l):
            return False
        want |= set(l["tops"])
    return True


def solved_layers(orig: list[dict], traffic: dict) -> list[dict]:
    """The layers a job solves, in graph order, by the module's rule:
    {consumer, producer (the shrunk conv, None for a gate), target, gate,
    depthwise (the depthwise convs the job shrinks for it, nearest
    first)}."""
    by = {l["name"]: l for l in orig}
    convs = [l["name"] for l in orig if l["type"] == "Convolution"]
    channels = {t: s[1] for t, s in
                shp.tensor_shapes(orig, (1, 3, 224, 224)).items()}
    inputs = traffic.get("input_targets") or {}
    outputs = traffic.get("channel_targets") or {}
    items = []
    for c in convs[1:]:
        if not _group1(by[c]):
            continue
        dws, top = _walk_up(orig, c)
        if c in inputs:
            t, gate, dws = int(inputs[c]), True, []
        else:
            p = dws[0] if dws else (top["name"] if top is not None
                                    and top["type"] == "Convolution" else None)
            if p is None or p not in outputs:
                continue
            t = int(outputs[p])
            gate = not (_group1(top) and _feeds_only(orig, top["name"], c))
            if gate:
                n = next((k for k, d in enumerate(dws)
                          if not _feeds_only(orig, d, c)), len(dws))
                dws = dws[:n]
        if t >= channels[by[c]["bottoms"][0]]:
            continue
        items.append({"consumer": c, "producer": None if gate else top["name"],
                      "target": t, "gate": gate, "depthwise": dws})
    return items


def _gate_of(out: list[dict], consumer: str) -> dict | None:
    """The Select of a gate, wherever along the consumer's chain of
    channel-preserving layers and depthwise convs it sits, or None."""
    _, top = _walk_up(out, consumer)
    return top if top is not None and top["type"] == "Select" else None


def counts_off(orig: list[dict], out: list[dict], traffic: dict,
               tol: float) -> tuple[int, list[str]]:
    """(how many solved layers leave their band or are missing, their
    names): a shrunk producer's outputs, or a gate's kept inputs."""
    by_out = {l["name"]: l for l in out}
    bad = []
    for it in solved_layers(orig, traffic):
        lo, hi = band(it["target"], tol)
        if it["consumer"] not in by_out:
            n = None
        elif it["gate"]:
            sel = _gate_of(out, it["consumer"])
            n = len(sel["attrs"].get("indices") or ()) if sel else None
        else:
            l = by_out.get(it["producer"])
            n = int(l["attrs"]["num_output"]) if l else None
        if n is None or not lo <= n <= hi:
            bad.append(it["consumer"])
    return len(bad), bad


def _device_params(params: Mapping, device) -> dict:
    return {k: {n: torch.as_tensor(np.asarray(v)).to(device).float()
                for n, v in d.items()} for k, d in params.items()}


def reference_freeze(orig: list[dict], params_t: Mapping, images: np.ndarray,
                     n_points: int, seed: int, include: set, device,
                     round_operands=None):
    """(tensors, plan, ground truth) of the reference's own freeze: the 4-D
    sampled tensors by the plan rule, plus the 2-D tensors in `include`."""
    tensors = [t for t in plain.sampled_tensors(orig, include_fc=True)]
    shapes = _shapes(orig, images)
    plan = plain.point_plan(shapes, tensors, images.shape[0], n_points, seed,
                            share_key=plain.junction_key(orig))
    tensors = [t for t in tensors if len(shapes[t]) == 4 or t in include]
    gt = plain.freeze(orig, params_t, images, tensors, plan, device,
                      round_operands=round_operands)
    return tensors, plan, gt


def _shapes(layers, images):
    return shp.tensor_shapes(layers, (int(images.shape[1]),) + tuple(images.shape[2:]))


def freeze_gap(cache_feats: Mapping, cache_plan: Mapping, ref_plan: Mapping,
               gt: Mapping) -> tuple[float, str]:
    for t, (ys, xs) in ref_plan.items():
        if t not in gt:
            continue
        got = cache_plan.get(t)
        if got is None or not (np.array_equal(got[0], ys)
                               and np.array_equal(got[1], xs)):
            return float("inf"), f"plan of {t}"
    if set(cache_feats) != set(gt):
        return float("inf"), "tensor set"
    return plain.max_gap(cache_feats, gt)


def _residual(orig: list[dict], tensor: str):
    """(junction top, the junction's other bottoms) when `tensor` is a
    summand of an Eltwise sum, else (tensor, ())."""
    for l in orig:
        if l["type"] == "Eltwise" and tensor in l["bottoms"]:
            return l["tops"][0], tuple(b for b in l["bottoms"] if b != tensor)
    return tensor, ()


def layer_rows(out: list[dict], out_params_t: Mapping, images: np.ndarray,
               plan: Mapping, items: list[dict], orig: list[dict], device,
               chunk: int = 5) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """{consumer: (X (N, c, kh, kw) its input patches in the compressed
    model at its planned points, the other junction summands (N, n) or
    None)}, computed `chunk` batches at a time."""
    by_out = {l["name"]: l for l in out}
    taps: dict[str, list] = {}
    for it in items:
        c = it["consumer"]
        l = by_out[c]
        taps.setdefault(l["bottoms"][0], []).append(("X", c, l["attrs"]))
        for o in _residual(orig, c)[1]:
            taps.setdefault(o, []).append(("other", c, None))
    nb, bs = images.shape[:2]
    got: dict[tuple, list] = {}
    for lo in range(0, nb, chunk):
        hi = min(nb, lo + chunk)
        x = torch.as_tensor(np.ascontiguousarray(images[lo:hi])).to(device) \
            .reshape((-1,) + tuple(images.shape[2:])).float()

        def tap(uses):
            def fn(v):
                res = []
                for kind, c, attrs in uses:
                    ys, xs = plan[c][0][lo:hi], plan[c][1][lo:hi]
                    res.append(((kind, c), plain.gather_patches(v, ys, xs, bs, attrs)
                                if kind == "X" else plain.gather_points(v, ys, xs, bs)))
                return res
            return fn

        for rows in plain.run(out, out_params_t, x,
                              {t: tap(u) for t, u in taps.items()}).values():
            for key, v in rows:
                got.setdefault(key, []).append(v)
    result = {}
    for it in items:
        c = it["consumer"]
        others = [torch.cat(got[("other", c)])] if ("other", c) in got else []
        result[c] = (torch.cat(got[("X", c)]), others[0] if others else None)
    return result


def _target(orig: list[dict], c: str, gt: Mapping, other) -> torch.Tensor:
    """The ground truth a solved layer `c` is fit to (N, n), in float64:
    its own output, or its junction's less the junction's other summands."""
    target, _ = _residual(orig, c)
    Y = gt[target].double()
    return Y - other.double() if other is not None else Y


def refit_excess(items: list[dict], rows: Mapping, gt: Mapping, orig: list[dict],
                 out_params: Mapping, selections: Mapping, ridge: float,
                 rounding: str | None = None) -> tuple[float, str, dict]:
    """(the largest (J - J_opt) / ||Y - mean||^2 over the solved layers, its
    layer, every layer's reading), J the refit's objective, the squared
    error plus lam ||W||^2 with the job's lam = LSTSQ_JITTER * trace +
    ridge (`plain.lstsq_fit`). A layer whose own outputs a later layer
    pruned is judged on the outputs kept (`selections` of that later
    layer): each output's fit is a problem of its own. With `rounding`, J
    is that of the reference's own refit on inputs rounded to that
    precision (the control)."""
    worst, where, each = -float("inf"), "", {}
    next_of = {it["producer"]: it["consumer"] for it in items if it["producer"]}
    for it in items:
        c = it["consumer"]
        X, other = rows[c]
        Y = _target(orig, c, gt, other).to(X.device)
        if c in next_of:
            keep = np.asarray(selections.get(next_of[c], ()), bool)
            if keep.shape != (Y.shape[1],):
                each[c] = float("inf")
                return float("inf"), c, each
            Y = Y[:, torch.as_tensor(keep, device=Y.device)]
        X2 = X.reshape(X.shape[0], -1)
        W_opt, b_opt, lam = plain.lstsq_fit(X2, Y, LSTSQ_JITTER, ridge)
        j_opt = plain.objective(X2, Y, W_opt, b_opt, lam)
        energy = float(torch.sum((Y - Y.mean(0)) ** 2))
        if rounding is None:
            W = torch.as_tensor(np.asarray(out_params[c]["W"])).to(X.device)
            b = torch.as_tensor(np.asarray(out_params[c].get(
                "b", np.zeros(W.shape[0], np.float32)))).to(X.device)
            W = W.reshape(W.shape[0], -1)
            ok = tuple(W.shape) == (Y.shape[1], X2.shape[1])
            j = plain.objective(X2, Y, W, b, lam) if ok else float("inf")
        else:
            Wc, bc, _ = plain.lstsq_fit(plain.ROUNDINGS[rounding](X2.float()),
                                        Y, LSTSQ_JITTER, ridge)
            j = plain.objective(X2, Y, Wc, bc, lam)
        v = (j - j_opt) / max(energy, 1e-300)
        if not math.isfinite(v):
            v = float("inf")
        each[c] = v
        if v > worst:
            worst, where = v, c
    return worst, where, each


def _folded(orig: list[dict], params_t: Mapping, conv: str
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, b) of an original conv with the BatchNorm and Scale that act on
    its output folded in, in float64: the weights the job starts from."""
    p = params_t[conv]
    W = p["W"].double()
    b = p["b"].double() if "b" in p else torch.zeros(W.shape[0], dtype=W.dtype,
                                                     device=W.device)
    top = next(l for l in orig if l["name"] == conv)["tops"][0]
    after = False
    for l in orig:
        if l["name"] == conv:
            after = True
            continue
        if not after:
            continue
        if l["type"] not in ("BatchNorm", "Scale") or l["bottoms"] != [top]:
            break
        q = params_t[l["name"]]
        if l["type"] == "BatchNorm":
            f = float(q["factor"]) if "factor" in q else 1.0
            inv = 1.0 if f == 0 else 1.0 / f
            sd = torch.sqrt(q["var"].double() * inv + float(l["attrs"].get("eps", 1e-5)))
            W, b = W / sd[:, None, None, None], (b - q["mean"].double() * inv) / sd
        else:
            g = q["W"].double()
            W, b = W * g[:, None, None, None], b * g
            if "b" in q:
                b = b + q["b"].double()
    return W, b


def running_net(out: list[dict], out_params: Mapping, orig: list[dict],
                params_t: Mapping, items: list[dict], selections: Mapping,
                rows: Mapping, gt: Mapping, ridge: float, device
                ) -> tuple[list[dict], dict]:
    """(layers, parameters) of the job's running net at full width, as each
    layer's search saw it: every gate, wherever it sits, passes all its
    channels; a solved layer reads all its input channels, the dropped ones
    through zero columns; a pruned producer has all its outputs, the kept
    ones the program's, the dropped ones the reference's own refit over the
    inputs the program kept (or, for a producer the job did not solve, its
    original weights); a depthwise conv the job shrank has all its
    channels again, its original weights. `rows` are the compressed
    model's (`layer_rows`)."""
    solved = {it["consumer"] for it in items}
    next_of = {it["producer"]: it["consumer"] for it in items if it["producer"]}
    shrunk_dw = {d for it in items for d in it["depthwise"]}
    by_orig = {l["name"]: l for l in orig}
    layers, params = [], {}
    for l in out:
        l = {**l, "attrs": dict(l["attrs"])}
        name = l["name"]
        if l["type"] == "Select":
            l["attrs"]["indices"] = None
        if name in shrunk_dw:
            a = by_orig[name]["attrs"]
            l["attrs"].update(num_output=a["num_output"], group=a["group"])
            W, b = _folded(orig, params_t, name)
            params[name] = {"W": W.float(), "b": b.float()}
            layers.append(l)
            continue
        p = {k: torch.as_tensor(np.asarray(v)).to(device).double()
             for k, v in out_params.get(name, {}).items()}
        if l["type"] == "Convolution" and (name in solved or name in next_of):
            if name in solved:
                keep_in = torch.as_tensor(np.asarray(selections[name], bool),
                                          device=device)
                W = p["W"]
                full_in = torch.zeros((W.shape[0], keep_in.numel()) + tuple(W.shape[2:]),
                                      dtype=W.dtype, device=device)
                full_in[:, keep_in] = W
                b = p.get("b", torch.zeros(W.shape[0], dtype=W.dtype, device=device))
                if name in next_of:
                    keep_out = torch.as_tensor(
                        np.asarray(selections[next_of[name]], bool), device=device)
                    X, other = rows[name]
                    Y = _target(orig, name, gt, other).to(device)
                    Wr, br, _ = plain.lstsq_fit(X.reshape(X.shape[0], -1), Y,
                                                LSTSQ_JITTER, ridge)
                    Wr = Wr.reshape((-1, int(keep_in.sum())) + tuple(W.shape[2:]))
                    Wf = torch.zeros((Y.shape[1],) + tuple(full_in.shape[1:]),
                                     dtype=W.dtype, device=device)
                    Wf[:, keep_in] = Wr
                    Wf[keep_out] = full_in
                    bf = br.clone()
                    bf[keep_out] = b
                    full_in, b = Wf, bf
                p = {"W": full_in, "b": b}
            else:
                W, b = _folded(orig, params_t, name)
                p = {"W": W, "b": b}
        params[name] = {k: v.float() for k, v in p.items()}
        layers.append(l)
    return layers, params


def solved_later(orig: list[dict], items: list[dict]) -> dict[str, set]:
    """{solved layer: the layers solved after it that the other summands of
    its junction depend on} (a shortcut solved before the branch beside
    it), for the layers that have such."""
    order = [it["consumer"] for it in items]
    late = {}
    for i, c in enumerate(order):
        others = _residual(orig, c)[1]
        after = set(order[i + 1:]) & shp.ancestors(orig, others) if others else set()
        if after:
            late[c] = after
    return late


def summands_as_solved(rows: Mapping, late: Mapping[str, set], run: tuple,
                       orig: list[dict], params_t: Mapping, images: np.ndarray,
                       plan: Mapping, items: list[dict], device) -> dict:
    """`rows` with the other junction summands of each layer of `late` as
    the job saw them when it solved that layer (c3.solve_prune fits a
    junction's summand to the ground truth less the other summands'
    current values): in the running net `run` with the layers solved after
    it at their original weights."""
    run_layers, run_params = run
    out = dict(rows)
    for it in items:
        c = it["consumer"]
        if c not in late:
            continue
        params = dict(run_params)
        for name in late[c]:
            W, b = _folded(orig, params_t, name)
            params[name] = {"W": W.float(), "b": b.float()}
        got = layer_rows(run_layers, params, images, plan, [it], orig, device)
        out[c] = (rows[c][0], got[c][1])
    return out


def select_off(items: list[dict], rows_full: Mapping, gt: Mapping,
               orig: list[dict], params_t: Mapping, selections: Mapping,
               alphas: Mapping, subsample: np.ndarray,
               rounding: str | None = None) -> dict:
    """Per solved layer, the share of the k channels the program kept that
    the reference's own LASSO does not keep: at the alpha the program
    reports for the layer, the k largest |beta| of the exact solution
    (`plain.lasso_at`, lam = alpha times Z's rows) of the layer's search
    problem, Z (`plain.channel_response`) of its full-width input X on the
    job's row subsample and its original weights, y the ground truth there
    less the bias and the junction's other summands. (The job's search
    keeps the k largest |beta| at the alpha it reports: the support where
    that has k channels, else the smallest support above k trimmed.) With
    `rounding`, the kept set is the reference's own on X and W rounded to
    that precision (the control)."""
    off = {}
    for it in items:
        c = it["consumer"]
        X, other = rows_full[c]
        W2, b2 = _folded(orig, params_t, c)
        W2 = W2.to(X.device)
        keep = np.asarray(selections.get(c, ()), bool)
        k = int(keep.sum())
        if keep.shape != (X.shape[1],) or k == 0 or c not in alphas:
            off[c] = float("inf")
            continue
        sub = torch.as_tensor(subsample, device=X.device)
        y = (_target(orig, c, gt, other).to(X.device)
             - b2.to(X.device)).index_select(0, sub).reshape(-1)
        Xs = X.index_select(0, sub)

        def chosen(Xs, Ws):
            Z = plain.channel_response(Xs, Ws)
            lam = float(alphas[c]) * Z.shape[0]
            return plain.top_k(plain.lasso_at(Z.T @ Z, Z.T @ y, lam).abs(), k)

        ref = chosen(Xs, W2)
        if rounding is not None:
            rnd = plain.ROUNDINGS[rounding]
            keep = chosen(rnd(Xs.float()), rnd(W2.float()))
        off[c] = float((keep & ~ref).sum()) / k
    return off


def depthwise_off(orig: list[dict], out: list[dict], out_params: Mapping,
                  params_t: Mapping, items: list[dict], selections: Mapping
                  ) -> dict[str, float]:
    """Per depthwise conv the job shrank or gated, max |W_out - W_orig[kept]|
    over the RMS of W_orig[kept], weights and bias together: W_orig its
    original weights with their BatchNorm and Scale folded in (`_folded`),
    kept the channels the consumer it feeds reports (`selections`); inf
    where its width, or a gate's Select in front of the chain, keeps
    another set of channels."""
    by_out = {l["name"]: l for l in out}
    off = {}
    for it in items:
        if not it["depthwise"]:
            continue
        keep = np.asarray(selections.get(it["consumer"], ()), bool)
        idx = np.flatnonzero(keep)
        k = len(idx)
        if it["consumer"] not in by_out:
            off.update({d: float("inf") for d in it["depthwise"]})
            continue
        if it["gate"]:
            sel = _gate_of(out, it["consumer"])
            got = sel["attrs"].get("indices") if sel else None
            if got is None or not np.array_equal(np.asarray(got), idx):
                off.update({d: float("inf") for d in it["depthwise"]})
                continue
        for d in it["depthwise"]:
            l, p = by_out.get(d), out_params.get(d, {})
            W0, b0 = _folded(orig, params_t, d)
            if l is None or "W" not in p or k == 0 or keep.shape != (W0.shape[0],) \
                    or int(l["attrs"]["num_output"]) != k \
                    or int(l["attrs"].get("group", 1)) != k:
                off[d] = float("inf")
                continue
            sel = torch.as_tensor(idx, device=W0.device)
            W0, b0 = W0.index_select(0, sel), b0.index_select(0, sel)
            W = torch.as_tensor(np.asarray(p["W"])).to(W0.device).double()
            b = torch.as_tensor(np.asarray(p.get("b", np.zeros(k, np.float32)))
                                ).to(W0.device).double()
            if W.shape != W0.shape or b.shape != b0.shape:
                off[d] = float("inf")
                continue
            ref = torch.cat([W0.reshape(-1), b0])
            rms = float(torch.sqrt(torch.mean(ref ** 2)))
            gap = float(torch.cat([(W - W0).reshape(-1), b - b0]).abs().max())
            off[d] = gap / max(rms, 1e-300)
    return off


def _largest(each: Mapping[str, float]) -> tuple[float, str]:
    if not each:
        return 0.0, ""
    where = max(each, key=lambda c: each[c])
    v = each[where]
    return (v if math.isfinite(v) else float("inf")), where


def head_error(orig: list[dict], params_t: Mapping, out: list[dict],
               out_params_t: Mapping, x: torch.Tensor, head: str) -> float:
    """||Y_c - Y_o||^2 / ||Y_o||^2 of the input of layer `head` (the
    classifier head) of the compressed against the original model."""
    def head_input(layers):
        return next(l["bottoms"][0] for l in layers if l["name"] == head)

    yo = plain.run(orig, params_t, x, {head_input(orig): lambda v: v.double()})
    yc = plain.run(out, out_params_t, x, {head_input(out): lambda v: v.double()})
    yo, yc = next(iter(yo.values())), next(iter(yc.values()))
    return float(torch.sum((yc - yo) ** 2) / torch.sum(yo ** 2))


def subsample_rows(n_rows: int, seed: int, subsample: int) -> np.ndarray:
    """The job's row subsample for its searches' Z: min(subsample,
    max(n_rows // 20, 1)) rows drawn by numpy's default_rng(seed)."""
    n_sub = min(int(subsample), max(n_rows // 20, 1))
    return np.random.default_rng(seed).integers(0, n_rows, size=n_sub)


def judge(orig: list[dict], params: Mapping, images: np.ndarray,
          held_out: torch.Tensor, config: dict, traffic: dict, cfg_values: dict,
          out: list[dict], out_params: Mapping, selections: Mapping,
          cache_feats: Mapping, cache_plan: Mapping, alphas: Mapping, device,
          control: bool = False, rounding: str | None = None) -> dict:
    """Every number of the cell and the model's head error. `cfg_values`
    holds the job's n_points, plan seed, rank_tol, row subsample and ridge;
    `alphas` the LASSO alpha the program reports for each solved layer.
    With `control`, the reference's lower-precision run takes the
    program's place: its freeze in TF32 (the freeze is f32 in every job)
    and its searches and refits in `rounding`, by default
    `traffic["control_rounding"]`, the next precision below the
    replays'."""
    reference_flags()
    rounding = (rounding or traffic["control_rounding"]) if control else None
    params_t = _device_params(params, device)
    include = {t for t, v in cache_feats.items() if np.ndim(v) == 2
               and t in {l["tops"][0] for l in orig if l["type"] == "InnerProduct"}}
    _, plan, gt = reference_freeze(orig, params_t, images,
                                   cfg_values["n_points"], cfg_values["seed"],
                                   include, device)
    nums: dict[str, float] = {}
    detail: dict[str, object] = {}
    if control:
        _, _, gt_lp = reference_freeze(orig, params_t, images,
                                       cfg_values["n_points"], cfg_values["seed"],
                                       include, device,
                                       round_operands=plain.round_tf32)
        gap, where = plain.max_gap({t: v.numpy() for t, v in gt_lp.items()}, gt)
    else:
        gap, where = freeze_gap(cache_feats, cache_plan, plan, gt)
    nums["freeze_gap"] = gap
    detail["freeze_gap_at"] = where
    n_off, off = counts_off(orig, out, traffic, cfg_values["rank_tol"])
    nums["counts_off"] = float(n_off)
    detail["counts_off_at"] = off
    items = solved_layers(orig, traffic)
    dw = depthwise_off(orig, out, out_params, params_t, items, selections)
    nums["depthwise_off"], detail["depthwise_off_at"] = _largest(dw)
    out_params_t = _device_params(out_params, device)
    nums["select_off"] = nums["refit_excess"] = float("inf")
    if not n_off:
        ridge = cfg_values["ridge"]
        gt_dev = {t: v.to(device) for t, v in gt.items()}
        rows = layer_rows(out, out_params_t, images, plan, items, orig, device)
        run, late = None, solved_later(orig, items)
        if late:
            try:
                run = running_net(out, out_params, orig, params_t, items,
                                  selections, rows, gt_dev, ridge, device)
                rows = summands_as_solved(rows, late, run, orig, params_t,
                                          images, plan, items, device)
            except (KeyError, IndexError, RuntimeError, ValueError) as exc:
                detail["select_error"] = repr(exc)[:300]
        ex, where, each = refit_excess(items, rows, gt_dev, orig, out_params,
                                       selections, ridge, rounding)
        nums["refit_excess"] = ex
        detail["refit_excess_at"] = where
        detail["refit_excess_each"] = each
        if math.isfinite(ex):
            try:
                run_layers, run_params = run or running_net(
                    out, out_params, orig, params_t, items, selections, rows,
                    gt_dev, ridge, device)
                others = {c: rows[c][1] for c in late}
                del rows
                rows_full = layer_rows(run_layers, run_params, images, plan,
                                       items, orig, device)
                rows_full = {c: (X, others.get(c, o))
                             for c, (X, o) in rows_full.items()}
                n_rows = next(iter(rows_full.values()))[0].shape[0]
                sub = subsample_rows(n_rows, cfg_values["seed"],
                                     cfg_values["subsample_rows"])
                so = select_off(items, rows_full, gt_dev, orig, params_t,
                                selections, alphas, sub, rounding)
                del rows_full
            except (KeyError, IndexError, RuntimeError, ValueError) as exc:
                so = {"error": float("inf")}
                detail["select_error"] = repr(exc)[:300]
            nums["select_off"], detail["select_off_at"] = _largest(so)
            detail["select_off_each"] = so
        del gt_dev
    detail["model_rel_err"] = head_error(orig, params_t, out, out_params_t,
                                         held_out, config["head"])
    return {"numbers": nums, "detail": detail}


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]
            ) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    rows = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name, float("inf"))
        rows[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, rows
