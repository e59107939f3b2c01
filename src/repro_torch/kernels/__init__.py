"""Public kernel entry points of the port.

``merged_conv_op`` (dense merged segments) and ``depthwise_conv_op``
(depthwise / grouped ones) launch hand-written CUDA kernels
(``csrc/*.cu``, built with ``nvcc`` for ``sm_90a`` at first use, see
:mod:`.cuda_build`) on CUDA tensors and run their plain PyTorch versions
(:mod:`.ref`) on CPU tensors.  Layouts at every public function are the
JAX package's: NHWC activations and HWIO weights.
"""
from . import ops, quant, ref
from .ops import (channel_tile, depthwise_conv_op, launch_counts,
                  merged_conv_op, reset_launch_counts)
from .ref import (apply_activation, depthwise_conv_qref, depthwise_conv_ref,
                  merged_conv_qref, merged_conv_ref)

__all__ = [
    "ops", "quant", "ref",
    "channel_tile", "depthwise_conv_op", "launch_counts", "merged_conv_op",
    "reset_launch_counts",
    "apply_activation", "depthwise_conv_qref", "depthwise_conv_ref",
    "merged_conv_qref", "merged_conv_ref",
]
