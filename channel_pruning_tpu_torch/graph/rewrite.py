"""Pure graph rewrites.

Replaces lib/net.py's stateful model surgery — insert/remove/set_conv/ch_*
(net.py:884-927,321-349), merge_bn (net.py:1114-1198), seperateConvReLU
(net.py:1228-1256), Filter-layer insertion (net.py:1627-1630,
builder.py:659-672), combineHP (net.py:1473-1504), add_bn (net.py:1001-1047)
— with pure functions (Graph, params) -> (Graph, params). No WPQ dict: weight
updates are applied to the params pytree immediately, keeping graph and
params consistent by construction.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from channel_pruning_tpu_torch.graph.ir import Graph, Layer, LT

Params = dict[str, dict[str, np.ndarray]]


def _copy_params(params: Mapping[str, Mapping[str, np.ndarray]]) -> Params:
    return {k: dict(v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# ReLU / BN in-place splitting
# ---------------------------------------------------------------------------

def split_relu(graph: Graph) -> Graph:
    """Give every in-place ReLU its own top so producer outputs are
    addressable (reference: seperateConvReLU, net.py:1228-1256)."""
    g = graph
    for relu in g.names_by_type(LT.RELU):
        l = g.layer(relu)
        if l.tops[0] != relu:
            bottom = l.bottoms[0]
            g = g.replace_layer(relu, l.with_tops([relu]))
            # rewire every later consumer of `bottom` to the relu output
            idx = g.index(relu)
            for i, other in enumerate(g.layers):
                if i <= idx or other.name == relu:
                    continue
                if bottom in other.bottoms:
                    g = g.replace_layer(
                        other.name,
                        other.with_bottoms([relu if b == bottom else b for b in other.bottoms]))
    g.validate()
    return g


def split_bn(graph: Graph) -> Graph:
    """Make in-place BN/Scale non-inplace (ResNet sampling path: conv output
    must stay addressable; reference seperateConvReLU resnet branch,
    net.py:1229-1243). The BN takes the conv name + '_bn' top; Scale stays
    in-place on the BN top; the ReLU and all later consumers move to it."""
    g = graph
    for bn in g.names_by_type(LT.BN):
        l = g.layer(bn)
        if l.tops[0] != bn:
            conv = l.bottoms[0]
            g = g.replace_layer(bn, l.with_tops([bn]))
            idx = g.index(bn)
            for i, other in enumerate(g.layers):
                if i <= idx or other.name == bn:
                    continue
                if conv in other.bottoms:
                    g = g.replace_layer(
                        other.name,
                        other.with_bottoms([bn if b == conv else b for b in other.bottoms]))
                    if other.tops[0] == conv:  # in-place successor (Scale/ReLU)
                        g = g.replace_layer(other.name, g.layer(other.name).with_tops(
                            [bn if t == conv else t for t in other.tops]))
    g.validate()
    return g


# ---------------------------------------------------------------------------
# BatchNorm folding
# ---------------------------------------------------------------------------

def merge_bn(graph: Graph, params: Mapping[str, Mapping[str, np.ndarray]],
             eps: float = 1e-9) -> tuple[Graph, Params]:
    """Fold BatchNorm+Scale pairs into the preceding conv's weights/bias.

    Math parity with reference merge_bn (net.py:1156-1173):
      y = ((w*x + b) - mean) / sqrt(var + eps) * k + beta
        = (w / std * k) x + (b - mean) / std * k + beta
    with (mean, var) descaled by the BN moving-average factor.
    """
    params = _copy_params(params)
    g = graph
    for bn_name in list(g.names_by_type(LT.BN)):
        if not g.has_layer(bn_name):
            continue
        bn = g.layer(bn_name)
        conv_l = g.producer_before(bn.bottoms[0], bn_name)
        if conv_l is None or conv_l.type != LT.CONV:
            continue
        conv = conv_l.name
        # find the Scale consuming this BN's top (possibly in-place aliased)
        scale_name = None
        bn_idx = g.index(bn_name)
        for i, l in enumerate(g.layers):
            if i > bn_idx and l.type == LT.SCALE and l.bottoms[0] in (bn.tops[0], bn_name):
                scale_name = l.name
                break
        bp = params[bn_name]
        factor = float(np.asarray(bp.get("factor", 1.0)))
        inv_f = 1.0 / factor if factor != 0 else 1.0
        mean = np.asarray(bp["mean"]) * inv_f
        std = np.sqrt(np.asarray(bp["var"]) * inv_f + eps)
        if scale_name is not None:
            k = np.asarray(params[scale_name]["W"])
            beta = np.asarray(params[scale_name].get("b", np.zeros_like(k)))
        else:
            k = np.ones_like(mean)
            beta = np.zeros_like(mean)

        w = np.asarray(params[conv]["W"])
        bias = np.asarray(params[conv].get("b", np.zeros(w.shape[0], w.dtype)))
        gain = (k / std).astype(w.dtype)
        params[conv]["W"] = w * gain[:, None, None, None]
        params[conv]["b"] = ((bias - mean) / std * k + beta).astype(w.dtype)

        new_conv = g.layer(conv).with_attrs(bias=True)
        # conv's effective top becomes the bn/scale output tensor name if
        # they were non-inplace; rewire so consumers keep resolving
        last_top = bn.tops[0]
        if scale_name is not None:
            last_top = g.layer(scale_name).tops[0]
        g = g.replace_layer(conv, new_conv)
        g = remove_layer(g, bn_name, rewire_to=conv_top(g, conv))
        if scale_name is not None:
            g = remove_layer(g, scale_name, rewire_to=conv_top(g, conv))
        params.pop(bn_name, None)
        if scale_name is not None:
            params.pop(scale_name, None)
        del last_top
    g.validate()
    return g, params


def conv_top(graph: Graph, name: str) -> str:
    return graph.layer(name).tops[0]


# ---------------------------------------------------------------------------
# structural edits
# ---------------------------------------------------------------------------

def remove_layer(graph: Graph, name: str, rewire_to: str | None = None) -> Graph:
    """Remove a layer, rewiring its consumers to `rewire_to` (defaults to the
    removed layer's bottom — reference rm_layer, builder.py:250-266)."""
    l = graph.layer(name)
    target = rewire_to if rewire_to is not None else l.bottoms[0]
    g = graph.without(name)
    for other in g.layers:
        changed = False
        bottoms = list(other.bottoms)
        for i, b in enumerate(bottoms):
            if b in l.tops:
                bottoms[i] = target
                changed = True
        if changed:
            g = g.replace_layer(other.name, other.with_bottoms(bottoms))
    return g


def insert_conv_after(graph: Graph, params: Mapping[str, Mapping[str, np.ndarray]],
                      after: str, name: str, W: np.ndarray, b: np.ndarray | None,
                      stride: tuple[int, int] | int = 1,
                      pad: tuple[int, int] | None = None) -> tuple[Graph, Params]:
    """Insert conv `name` consuming `after`'s top; all previous consumers of
    that top move to the new conv (reference insert, net.py:884-911)."""
    params = _copy_params(params)
    prev = graph.layer(after)
    src = prev.tops[0]
    kh, kw = int(W.shape[2]), int(W.shape[3])
    if pad is None:
        pad = (kh // 2, kw // 2)
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    new = Layer.make(name, LT.CONV, [src], num_output=int(W.shape[0]),
                     kernel_h=kh, kernel_w=kw, stride_h=sh, stride_w=sw,
                     pad_h=pad[0], pad_w=pad[1], bias=b is not None)
    g = graph
    after_idx = g.index(after)
    for i, other in enumerate(g.layers):
        if i <= after_idx:
            continue
        if src in other.bottoms:
            g = g.replace_layer(other.name, other.with_bottoms(
                [name if bt == src else bt for bt in other.bottoms]))
    g = g.insert_after(after, new)
    params[name] = {"W": np.asarray(W)}
    if b is not None:
        params[name]["b"] = np.asarray(b)
    g.validate()
    return g, params


def set_conv(graph: Graph, params: Mapping[str, Mapping[str, np.ndarray]], name: str,
             W: np.ndarray | None = None, b: np.ndarray | None = None,
             new_name: str | None = None, **attr_updates) -> tuple[Graph, Params]:
    """Update a conv's weights and/or attrs, optionally renaming it
    (reference set_conv, net.py:321-349 + rename in R3, net.py:1466)."""
    params = _copy_params(params)
    g = graph
    l = g.layer(name)
    if W is not None:
        params.setdefault(name, {})["W"] = np.asarray(W)
        attr_updates.setdefault("num_output", int(W.shape[0]))
        attr_updates.setdefault("kernel_h", int(W.shape[2]))
        attr_updates.setdefault("kernel_w", int(W.shape[3]))
        d = l.attr_dict
        for k in ("kernel_size",):
            if k in d:
                attr_updates.setdefault("kernel_h", int(W.shape[2]))
        # drop square shorthand in favour of explicit h/w when shapes change
    if b is not None:
        params.setdefault(name, {})["b"] = np.asarray(b)
        attr_updates.setdefault("bias", True)
    if attr_updates:
        d = l.attr_dict
        if any(k.startswith(("kernel_", "pad_", "stride_")) for k in attr_updates):
            for sq, pair in (("kernel_size", ("kernel_h", "kernel_w")),
                             ("pad", ("pad_h", "pad_w")),
                             ("stride", ("stride_h", "stride_w"))):
                if sq in d and any(p in attr_updates for p in pair):
                    val = d.pop(sq)
                    d.setdefault(pair[0], val)
                    d.setdefault(pair[1], val)
        d.update(attr_updates)
        from channel_pruning_tpu_torch.graph.ir import _freeze
        import dataclasses
        l = dataclasses.replace(l, attrs=_freeze(d))
    g = g.replace_layer(name, l)
    if new_name is not None:
        g = rename_layer(g, name, new_name)
        if name in params:
            params[new_name] = params.pop(name)
    g.validate()
    return g, params


def rename_layer(graph: Graph, old: str, new: str) -> Graph:
    l = graph.layer(old)
    old_top = l.tops[0]
    g = graph.replace_layer(old, l.renamed(new))
    if old_top == old:
        for other in g.layers:
            if other.name == new:
                continue
            if old_top in other.bottoms:
                g = g.replace_layer(other.name, other.with_bottoms(
                    [new if b == old_top else b for b in other.bottoms]))
            if old_top in other.tops and other.name != new:
                g = g.replace_layer(other.name, other.with_tops(
                    [new if t == old_top else t for t in other.tops]))
    return g


def insert_select(graph: Graph, after_tensor: str, consumer: str,
                  indices: np.ndarray) -> Graph:
    """Insert a static channel gather between `after_tensor` and one
    `consumer` — the TPU-native Filter layer (reference select,
    net.py:1627-1630; builder.py:659-672). Unlike Caffe's runtime Filter
    blob, this is a compile-time gather: XLA folds it into the consumer's
    conv when possible."""
    idxs = np.where(np.asarray(indices))[0] if np.asarray(indices).dtype == bool \
        else np.asarray(indices)
    name = f"{after_tensor}_Filter"
    base = name
    suffix = 0
    while graph.has_layer(name):
        suffix += 1
        name = f"{base}{suffix}"
    sel = Layer.make(name, LT.SELECT, [after_tensor],
                     indices=tuple(int(i) for i in idxs),
                     num_output=int(len(idxs)))
    prod = graph.producer(after_tensor)
    g = graph.insert_after(prod.name, sel)
    cons = g.layer(consumer)
    g = g.replace_layer(consumer, cons.with_bottoms(
        [name if b == after_tensor else b for b in cons.bottoms]))
    g.validate()
    return g


# ---------------------------------------------------------------------------
# channel pruning application
# ---------------------------------------------------------------------------

def prune_conv_inputs(graph: Graph, params: Mapping[str, Mapping[str, np.ndarray]],
                      name: str, keep: np.ndarray, W: np.ndarray | None = None,
                      b: np.ndarray | None = None) -> tuple[Graph, Params]:
    """Physically shrink conv `name`'s input channels to `keep` (bool mask),
    installing reconstructed weights W (n, keep, kh, kw) and bias b.
    (reference W2keep, net.py:1610-1625, but the graph is rewritten instead
    of zeroing channels.)"""
    params = _copy_params(params)
    old_w = np.asarray(params[name]["W"])
    keep = np.asarray(keep, bool)
    new_w = old_w[:, keep] if W is None else np.asarray(W)
    params[name]["W"] = new_w
    if b is not None:
        params[name]["b"] = np.asarray(b)
    return graph, params


def prune_conv_outputs(graph: Graph, params: Mapping[str, Mapping[str, np.ndarray]],
                       name: str, keep: np.ndarray) -> tuple[Graph, Params]:
    """Shrink conv `name`'s output channels to `keep` and update num_output
    (reference W1keep, net.py:1521-1608; BN/Scale params riding the conv are
    sliced too)."""
    params = _copy_params(params)
    keep = np.asarray(keep, bool)
    params[name]["W"] = np.asarray(params[name]["W"])[keep]
    if "b" in params[name]:
        params[name]["b"] = np.asarray(params[name]["b"])[keep]
    g, params = set_conv(graph, params, name, num_output=int(keep.sum()))
    # slice any BN/Scale that rides this conv's top
    top = g.layer(name).tops[0]
    for other in g.layers:
        if other.type in (LT.BN, LT.SCALE) and other.bottoms[0] in (top, name):
            p = params.get(other.name)
            if p:
                params[other.name] = {k: (np.asarray(v)[keep] if np.asarray(v).ndim >= 1
                                          and np.asarray(v).shape[0] == len(keep) else v)
                                      for k, v in p.items()}
    return g, params


# ---------------------------------------------------------------------------
# H/P merge (reference combineHP, net.py:1473-1504)
# ---------------------------------------------------------------------------

def combine_hp(graph: Graph, params: Mapping[str, Mapping[str, np.ndarray]]
               ) -> tuple[Graph, Params]:
    """Merge each `*_H` (k x k, rank m) conv into its `*_P` (1x1, o outputs)
    successor when 3m >= 2o: W = P(o,m) @ H(m,-) reshaped, b = p_b + P @ h_b.
    The merged conv keeps H's geometry with o outputs; P is removed."""
    params = _copy_params(params)
    g = graph
    hs = [c for c in g.convs if c.endswith("_H")]
    # pair by prefix: layers whose ITQ stage was rejected are VH-only (no P)
    pairs = [(h, f"{h[:-2]}_P") for h in hs if g.has_layer(f"{h[:-2]}_P")]
    for h, p in pairs:
        Hw = np.asarray(params[h]["W"])
        Pw = np.asarray(params[p]["W"])
        m, o = Hw.shape[0], Pw.shape[0]
        if 3 * m >= 2 * o:
            Hb = np.asarray(params[h].get("b", np.zeros(m, Hw.dtype)))
            Pb = np.asarray(params[p].get("b", np.zeros(o, Pw.dtype)))
            P2 = Pw.reshape(o, -1)
            neww = (P2 @ Hw.reshape(m, -1)).reshape((o,) + Hw.shape[1:])
            newb = Pb + P2 @ Hb
            params[h]["W"] = neww
            params[h]["b"] = newb
            # bias on: an ITQ H conv is biasless, and the merged conv carries
            # P's bias (the JAX package's copy leaves the flag off, so the
            # forward drops the bias)
            g, params = set_conv(g, params, h, num_output=o, bias=True)
            g = remove_layer(g, p)
            params.pop(p, None)
    g.validate()
    return g, params


# ---------------------------------------------------------------------------
# BN restoration for finetuning (reference add_bn, net.py:1001-1047)
# ---------------------------------------------------------------------------

def add_bn_after_convs(graph: Graph, params: Mapping[str, Mapping[str, np.ndarray]],
                       stats: Mapping[str, tuple[np.ndarray, np.ndarray]],
                       ) -> tuple[Graph, Params]:
    """Insert BatchNorm+Scale after each conv in `stats` (name -> (mean, std))
    initialised so the net's function is unchanged: BN normalises by the
    measured statistics and the Scale holds (std, mean) exactly like the
    reference's WPQ[(scale,0)]=std, WPQ[(scale,1)]=mean (net.py:1042-1043)."""
    params = _copy_params(params)
    g = graph
    for conv, (mean, std) in stats.items():
        top = g.layer(conv).tops[0]
        bn_name, sc_name = f"{conv}_bn", f"{conv}_scale"
        bn = Layer.make(bn_name, LT.BN, [top], [top], eps=1e-9)
        sc = Layer.make(sc_name, LT.SCALE, [top], [top], bias=True)
        g = g.insert_after(conv, bn)
        g = g.insert_after(bn_name, sc)
        mean = np.asarray(mean, np.float32)
        std = np.asarray(std, np.float32)
        params[bn_name] = {"mean": mean, "var": std ** 2,
                           "factor": np.ones((), np.float32)}
        params[sc_name] = {"W": std, "b": mean}
    g.validate()
    return g, params
