"""channel_pruning_tpu_torch — the PyTorch/CUDA port of channel_pruning_tpu.

The JAX package stays the reference; this package re-implements its
channel-pruning main path (`cli prune --mode prune`) in PyTorch, with the
LASSO coordinate-descent kernel written by hand in CUDA for Hopper
(csrc/lasso_cd.cu). The JAX package's jax-free modules (graph IR and
rewrites, Caffe codecs, model definitions, config, FLOPs, checkpoint) are
imported as they are; nothing here imports jax.

Conventions: plain functions on tensors with an explicit `device`;
activations NCHW; parameters are dicts of tensors in Caffe layout
(conv W (O, I/g, kh, kw), FC W (O, CHW)), so every public function is
comparable one-to-one with its JAX counterpart.
"""
