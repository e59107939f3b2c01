"""Public kernel entry points of the port.

``merged_conv_op`` (dense merged segments), ``depthwise_conv_op``
(depthwise / grouped ones), ``merged_ffn_op`` (the transformer's
rank-r residual segments), ``rmsnorm_op`` (the pre-norms),
``flash_attention_op`` (prefill attention) and ``rglru_scan_op`` (the
RG-LRU recurrence, its gradient a kernel too) launch hand-written CUDA
kernels (``csrc/*.cu``, built with ``nvcc`` for ``sm_90a`` at first use, see
:mod:`.cuda_build`) on CUDA tensors and run their plain PyTorch versions
(:mod:`.ref`) on CPU tensors.  Layouts at every public function are the
JAX package's: NHWC activations and HWIO weights, ``(..., D)``
activations and ``(D, R)`` / ``(R, D)`` rank factors, ``(B, S, H, D)``
attention and ``(B, S, C)`` scans.
"""
from . import ops, quant, ref
from .ops import (channel_tile, depthwise_conv_op, flash_attention_op,
                  launch_counts, merged_conv_op, merged_ffn_op,
                  reset_launch_counts, rglru_scan_op, rmsnorm_op)
from .ref import (apply_activation, depthwise_conv_qref, depthwise_conv_ref,
                  flash_attention_ref, merged_conv_qref, merged_conv_ref,
                  merged_ffn_qref, merged_ffn_ref, rglru_scan_bwd_ref,
                  rglru_scan_ref, rmsnorm_ref)

__all__ = [
    "ops", "quant", "ref",
    "channel_tile", "depthwise_conv_op", "flash_attention_op",
    "launch_counts", "merged_conv_op", "merged_ffn_op",
    "reset_launch_counts", "rglru_scan_op", "rmsnorm_op",
    "apply_activation", "depthwise_conv_qref", "depthwise_conv_ref",
    "flash_attention_ref", "merged_conv_qref", "merged_conv_ref",
    "merged_ffn_qref", "merged_ffn_ref", "rglru_scan_bwd_ref",
    "rglru_scan_ref", "rmsnorm_ref",
]
