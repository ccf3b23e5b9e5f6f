"""The JAX package's jax-free pieces that the port uses unchanged (graph
rewrites, the model registry, the Caffe codec, config, FLOP counting),
re-exported so that a script can reach them through the port alone."""
from channel_pruning_tpu.graph.rewrite import split_relu
from channel_pruning_tpu.io.caffe import import_model
from channel_pruning_tpu.models.vgg import (VGG16_5X_CHANNELS, build_tiny_vgg,
                                            build_vgg16)
from channel_pruning_tpu.utils.config import default_config
from channel_pruning_tpu.utils.flops import total_flops

__all__ = ["VGG16_5X_CHANNELS", "build_tiny_vgg", "build_vgg16",
           "default_config", "import_model", "split_relu", "total_flops"]
