"""Plain PyTorch versions of the hand-written kernels.

Each ``*_ref`` is the semantic ground truth for its kernel: the op
wrappers in :mod:`repro_torch.kernels.ops` run it for tensors on the CPU,
the CPU tests hold it against the JAX package, and ``chip_smoke.py``
holds each CUDA kernel against it on the card.  Layouts are the JAX
package's: NHWC activations, HWIO weights (grouped weights
``(kh, kw, Cin/g, Cout)``, group-major output channels).

All math is fp32.  On the card these functions call ``F.conv2d``;
callers disable TF32 first (:func:`repro_torch.device.resolve`), or
cuDNN would round the operands to TF32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _conv_nhwc(x, w, stride: int, groups: int):
    """VALID NHWC × HWIO convolution in fp32 (no bias)."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w.float().permute(3, 2, 0, 1), stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def merged_conv_ref(x, w, b=None, stride: int = 1):
    """VALID NHWC conv (stride ``s``) + bias — the merged-segment layer."""
    y = _conv_nhwc(x, w, stride, 1)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype).contiguous()


def depthwise_conv_ref(x, w, b=None, stride: int = 1,
                       groups: int | None = None):
    """VALID NHWC grouped conv + bias — depthwise when ``groups == Cin``.

    ``w`` is HWIO ``(kh, kw, Cin/g, Cout)``; ``groups`` defaults to the
    depthwise reading ``Cin // Cin_g``.
    """
    if groups is None:
        groups = x.shape[-1] // w.shape[2]
    y = _conv_nhwc(x, w, stride, groups)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype).contiguous()


def _w8a8(x):
    from . import quant
    xq, xs = quant.quantize_int8(x)
    return quant.dequantize(xq, xs)


def merged_conv_qref(x, wq, b, w_scale, *, stride: int = 1,
                     act_quant: str = "none"):
    """Dequantizing version of the quantized ``merged_conv`` path
    (``wq`` narrow HWIO, ``w_scale`` per-output-channel, axis 3)."""
    from . import quant
    w = quant.dequantize(wq, w_scale, axis=3)
    if act_quant == "w8a8":
        x = _w8a8(x)
    return merged_conv_ref(x, w, b, stride=stride)


def depthwise_conv_qref(x, wq, b, w_scale, *, stride: int = 1,
                        groups: int | None = None,
                        act_quant: str = "none"):
    """Dequantizing version of the quantized grouped/depthwise path."""
    from . import quant
    w = quant.dequantize(wq, w_scale, axis=3)
    if act_quant == "w8a8":
        x = _w8a8(x)
    return depthwise_conv_ref(x, w, b, stride=stride, groups=groups)


def apply_activation(y, name=None):
    """Boundary activation σ_j of a merged segment (the fused kernel
    epilogue's plain version); fp32 math regardless of storage dtype."""
    if name is None or name == "none":
        return y
    z = y.float()
    if name == "relu":
        z = torch.clamp(z, min=0.0)
    elif name == "relu6":
        z = torch.clamp(z, 0.0, 6.0)
    elif name == "silu":
        z = F.silu(z)
    else:
        raise ValueError(f"unknown activation {name!r}")
    return z.to(y.dtype)
