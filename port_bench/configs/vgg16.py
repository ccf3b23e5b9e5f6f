"""Plain reference of VGG-16 (Simonyan and Zisserman 2014; the Caffe
ILSVRC-2014 16-layer deploy prototxt): 3x3 pad-1 convs with ReLU in
stages, 2x2 stride-2 max pools, three inner products with ReLU and dropout.
Each ReLU writes a tensor named after itself, so every conv's own output
(before its ReLU) keeps the conv's name."""
from __future__ import annotations

from port_bench.reference.plain import layer


def layers(cfg: dict) -> list[dict]:
    out, prev = [], "data"
    for stage, blocks, width in cfg["stages"]:
        for b in range(1, blocks + 1):
            conv, relu = f"conv{stage}_{b}", f"relu{stage}_{b}"
            out.append(layer(conv, "Convolution", [prev], num_output=width,
                             kernel_size=3, pad=1, stride=1, bias=True))
            out.append(layer(relu, "ReLU", [conv]))
            prev = relu
        out.append(layer(f"pool{stage}", "Pooling", [prev], pool="max",
                         kernel_size=2, stride=2))
        prev = f"pool{stage}"
    for i, dim in enumerate(cfg["fc_dims"], start=6):
        out.append(layer(f"fc{i}", "InnerProduct", [prev], num_output=dim))
        out.append(layer(f"relu{i}", "ReLU", [f"fc{i}"]))
        out.append(layer(f"drop{i}", "Dropout", [f"relu{i}"], dropout_ratio=0.5))
        prev = f"drop{i}"
    out.append(layer("fc8", "InnerProduct", [prev], num_output=cfg["num_classes"]))
    out.append(layer("prob", "Softmax", ["fc8"]))
    return out
