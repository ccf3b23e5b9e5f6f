"""The JAX package's jax-free pieces that the port uses unchanged (graph
rewrites, the model registry, the Caffe codec, config, FLOP counting),
re-exported so that a script can reach them through the port alone."""
from channel_pruning_tpu.graph.ir import LT
from channel_pruning_tpu.graph.rewrite import split_relu
from channel_pruning_tpu.io.caffe import import_model
from channel_pruning_tpu.models.resnet import (RESNET50_2X_BRANCH2A,
                                               RESNET50_2X_BRANCH2B,
                                               RESNET50_2X_FILTERS,
                                               build_resnet50,
                                               build_tiny_resnet,
                                               resnet50_2x_targets)
from channel_pruning_tpu.models.vgg import (VGG16_5X_CHANNELS, build_tiny_vgg,
                                            build_vgg16)
from channel_pruning_tpu.utils.config import default_config
from channel_pruning_tpu.utils.flops import total_flops

__all__ = ["LT", "RESNET50_2X_BRANCH2A", "RESNET50_2X_BRANCH2B",
           "RESNET50_2X_FILTERS", "VGG16_5X_CHANNELS", "build_resnet50",
           "build_tiny_resnet", "build_tiny_vgg", "build_vgg16",
           "default_config", "import_model", "resnet50_2x_targets",
           "split_relu", "total_flops"]
