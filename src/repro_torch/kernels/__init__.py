"""Public kernel entry points of the port.

``merged_conv_op`` (dense merged segments), ``depthwise_conv_op``
(depthwise / grouped ones) and ``merged_ffn_op`` (the transformer's
rank-r residual segments) launch hand-written CUDA kernels
(``csrc/*.cu``, built with ``nvcc`` for ``sm_90a`` at first use, see
:mod:`.cuda_build`) on CUDA tensors and run their plain PyTorch versions
(:mod:`.ref`) on CPU tensors.  Layouts at every public function are the
JAX package's: NHWC activations and HWIO weights, ``(..., D)``
activations and ``(D, R)`` / ``(R, D)`` rank factors.
"""
from . import ops, quant, ref
from .ops import (channel_tile, depthwise_conv_op, launch_counts,
                  merged_conv_op, merged_ffn_op, reset_launch_counts)
from .ref import (apply_activation, depthwise_conv_qref, depthwise_conv_ref,
                  merged_conv_qref, merged_conv_ref, merged_ffn_qref,
                  merged_ffn_ref)

__all__ = [
    "ops", "quant", "ref",
    "channel_tile", "depthwise_conv_op", "launch_counts", "merged_conv_op",
    "merged_ffn_op", "reset_launch_counts",
    "apply_activation", "depthwise_conv_qref", "depthwise_conv_ref",
    "merged_conv_qref", "merged_conv_ref", "merged_ffn_qref",
    "merged_ffn_ref",
]
