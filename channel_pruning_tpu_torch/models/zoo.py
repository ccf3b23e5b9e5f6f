"""Model registry (reference: cfgs.Models / per-model classes, lib/cfgs.py:56-66)."""
from __future__ import annotations

from typing import Callable

from channel_pruning_tpu_torch.graph.ir import Graph
from channel_pruning_tpu_torch.models import faster_rcnn, resnet, vgg, xception


MODEL_REGISTRY: dict[str, dict] = {
    "vgg16": {
        "build": vgg.build_vgg16,
        "flops": vgg.VGG16_FLOPS,
        "accname": "accuracy@5",
        "family": "vgg",
    },
    "resnet50": {
        "build": resnet.build_resnet50,
        "flops": resnet.RESNET50_FLOPS,
        "accname": "accuracy@5",
        "family": "resnet",
    },
    "digits_vgg": {
        "build": vgg.build_digits_vgg,
        "flops": None,
        "accname": "accuracy@1",
        "family": "vgg",
    },
    "tiny_vgg": {
        "build": lambda **kw: vgg.build_tiny_vgg(**kw)[0],
        "flops": None,
        "accname": "accuracy@1",
        "family": "vgg",
    },
    "tiny_resnet": {
        "build": lambda **kw: resnet.build_tiny_resnet(**kw)[0],
        "flops": None,
        "accname": "accuracy@1",
        "family": "resnet",
    },
    "xception": {
        "build": xception.build_xception,
        "flops": None,
        "accname": "accuracy@5",
        "family": "xception",
    },
    "tiny_xception": {
        "build": lambda **kw: xception.build_tiny_xception(**kw)[0],
        "flops": None,
        "accname": "accuracy@1",
        "family": "xception",
    },
    "frcnn_vgg16": {
        "build": faster_rcnn.build_frcnn_backbone,
        "flops": None,
        "accname": None,
        "family": "frcnn",
    },
    "tiny_frcnn": {
        "build": lambda **kw: faster_rcnn.build_tiny_frcnn(**kw)[0],
        "flops": None,
        "accname": None,
        "family": "frcnn",
    },
    "cifar_resnet20": {
        "build": lambda **kw: resnet.build_cifar_resnet(n=3, **kw),
        "flops": None,
        "accname": "accuracy@1",
        "family": "resnet",
    },
    "cifar_plain20": {
        "build": lambda **kw: resnet.build_cifar_plain(n=3, **kw),
        "flops": None,
        "accname": "accuracy@1",
        "family": "plain",
    },
}

def get_model(name: str, **kwargs) -> Graph:
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODEL_REGISTRY)}")
    build: Callable[..., Graph] = MODEL_REGISTRY[name]["build"]
    return build(**kwargs)
