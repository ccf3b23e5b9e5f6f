"""Faster-RCNN VGG-16 backbone (+ RPN head) for detection-model pruning
(port of channel_pruning_tpu/models/faster_rcnn.py, numpy-only).

The backbone is VGG-16 conv1_1..conv5_3 without pool5 (detection keeps 1/16
resolution) plus the standard 3x3 RPN conv and its 1x1 cls/bbox heads.
"""
from __future__ import annotations

from channel_pruning_tpu_torch.graph.ir import Graph, Layer, LT, TensorSpec
from channel_pruning_tpu_torch.models.vgg import VGG16_CFG


def build_frcnn_backbone(batch: int = 1, image_size: int = 600,
                         num_anchors: int = 9, with_rpn: bool = True,
                         cfg=VGG16_CFG, name: str = "frcnn_vgg16") -> Graph:
    layers: list[Layer] = []
    prev = "data"
    n_stages = len(cfg)
    for si, (stage, blocks, ch) in enumerate(cfg):
        for b in range(1, blocks + 1):
            conv = f"conv{stage}_{b}"
            layers.append(Layer.make(conv, LT.CONV, [prev], num_output=ch,
                                     kernel_size=3, pad=1, stride=1, bias=True))
            layers.append(Layer.make(f"relu{stage}_{b}", LT.RELU, [conv], [conv]))
            prev = conv
        if si < n_stages - 1:          # no pool5: keep 1/16 resolution
            pool = f"pool{stage}"
            layers.append(Layer.make(pool, LT.POOL, [prev], pool="max",
                                     kernel_size=2, stride=2))
            prev = pool

    if with_rpn:
        layers.append(Layer.make("rpn_conv/3x3", LT.CONV, [prev],
                                 ["rpn/output"], num_output=512,
                                 kernel_size=3, pad=1, stride=1, bias=True))
        layers.append(Layer.make("rpn_relu/3x3", LT.RELU, ["rpn/output"],
                                 ["rpn/output"]))
        layers.append(Layer.make("rpn_cls_score", LT.CONV, ["rpn/output"],
                                 num_output=2 * num_anchors, kernel_size=1,
                                 pad=0, stride=1, bias=True))
        layers.append(Layer.make("rpn_bbox_pred", LT.CONV, ["rpn/output"],
                                 num_output=4 * num_anchors, kernel_size=1,
                                 pad=0, stride=1, bias=True))

    g = Graph(name=name,
              inputs=(TensorSpec("data", (batch, 3, image_size, image_size)),),
              layers=tuple(layers))
    g.validate()
    return g


def frcnn_heads(graph: Graph, num_anchors: int | None = None):
    """The RPN finetune heads: a 2-way softmax per anchor on
    `rpn_cls_score` plus SmoothL1 on `rpn_bbox_pred` (the py-faster-rcnn
    RPN losses), used as distillation targets against the frozen original
    backbone so the pruned net recovers without detection labels."""
    from channel_pruning_tpu_torch.train.finetune import HeadSpec

    names = {l.name for l in graph.layers}
    if "rpn_cls_score" not in names or "rpn_bbox_pred" not in names:
        raise ValueError("graph has no RPN heads (built with with_rpn=False?)")
    return (HeadSpec("rpn_cls_score", kind="softmax_distill", classes=2),
            HeadSpec("rpn_bbox_pred", kind="smooth_l1"))


def build_tiny_frcnn(batch: int = 2, image_size: int = 48, seed: int = 0):
    from channel_pruning_tpu_torch.models.vgg import init_params

    cfg = ((1, 2, 8), (2, 2, 12), (3, 2, 16))
    g = build_frcnn_backbone(batch=batch, image_size=image_size,
                             num_anchors=3, cfg=cfg, name="tiny_frcnn")
    return g, init_params(g, seed=seed)
