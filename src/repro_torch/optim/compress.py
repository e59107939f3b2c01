"""int8 gradient compression with error feedback.

Quantizing gradients to int8 with one scale a leaf cuts the bytes of a
gradient all-reduce 4× (fp32); the quantization residual is carried to
the next step (error feedback), so the errors telescope instead of
accumulating (Karimireddy et al., 2019).  The codes come from the port's
one rounding rule (:mod:`repro_torch.kernels.quant`, bitwise the JAX
package's), shared with the quantized merged kernels.

:func:`compressed_psum` is the collective: over the ranks of a mesh
axis, every leaf's ``amax`` is all-reduced (MAX), each rank quantizes its
tensor with the one scale ``max(amax, 1e-30) / 127``, the int32 codes are
all-reduced (SUM, exact below 2^23 ranks) and the sum is dequantized:
the JAX package's ``compressed_psum``, step for step and bitwise.
:func:`repro_torch.sharding.collectives.compressed_allreduce` binds it to
a mesh axis.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant import dequantize_int8
from repro_torch.kernels.quant import quantize_int8
from repro_torch.tree import flatten_tree, tree_map, tree_map_with_path

__all__ = ["ErrorFeedback", "compressed_psum", "dequantize_int8",
           "quantize_int8"]


def compressed_psum(tree, mesh, axes, *, codes=None):
    """The int8-quantized sum of every leaf of ``tree`` over the ranks of
    ``axes`` (a mesh axis or a tuple of them), fp32, the same on every
    rank.  ``codes`` (a dict, optional) receives each leaf's summed int32
    codes by key path."""
    from repro_torch.kernels.quant import INT8_QMAX, _scale
    from repro_torch.sharding import collectives as C

    def one(key, x):
        scale = _scale(x, None, INT8_QMAX, reduce_amax=lambda a: C.all_reduce(
            a.reshape(1).clone(), mesh, axes, "max").reshape(()))
        q = torch.clamp(torch.round(x.float() / scale), -INT8_QMAX,
                        INT8_QMAX).to(torch.int32)
        total = C.all_reduce(q, mesh, axes, "sum")
        if codes is not None:
            codes[key] = total
        return total.float() * scale
    return tree_map_with_path(one, tree)


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
