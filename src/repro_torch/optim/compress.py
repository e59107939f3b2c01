"""int8 gradient compression with error feedback.

Quantizing gradients to int8 with one scale a leaf cuts the bytes of a
gradient all-reduce 4× (fp32); the quantization residual is carried to
the next step (error feedback), so the errors telescope instead of
accumulating (Karimireddy et al., 2019).  The codes come from the port's
one rounding rule (:mod:`repro_torch.kernels.quant`, bitwise the JAX
package's), shared with the quantized merged kernels.

The JAX package's ``compressed_psum`` is a collective over a mesh axis;
it belongs to the port's distribution slice (ROADMAP.md queue 1 item 5)
and is not here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant import dequantize as dequantize_int8
from repro_torch.kernels.quant import quantize_int8
from repro_torch.tree import flatten_tree, tree_map, tree_map_with_path

__all__ = ["ErrorFeedback", "dequantize_int8", "quantize_int8"]


class ErrorFeedback:
    """g_compressed = Q(g + e);  e ← (g + e) − g_compressed."""

    @staticmethod
    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    @staticmethod
    def apply(grads, error):
        """``(compressed grads, new error)``, both fp32 trees shaped like
        ``grads``."""
        flat_e = flatten_tree(error)
        out = {}

        def one(key, g):
            corrected = g.to(torch.float32) + flat_e[key]
            q, scale = quantize_int8(corrected)
            gq = dequantize_int8(q, scale)
            out[key] = corrected - gq
            return gq
        compressed = tree_map_with_path(one, grads)
        return compressed, tree_map_with_path(lambda k, _: out[k], grads)
