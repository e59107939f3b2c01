"""Plain PyTorch versions of the hand-written kernels.

Each ``*_ref`` is the semantic ground truth for its kernel: the op
wrappers in :mod:`repro_torch.kernels.ops` run it for tensors on the CPU,
the CPU tests hold it against the JAX package, and ``chip_smoke.py``
holds each CUDA kernel against it on the card.  Layouts are the JAX
package's: NHWC activations, HWIO weights (grouped weights
``(kh, kw, Cin/g, Cout)``, group-major output channels), ``(..., D)``
rows for the norm, ``(B, S, H, D)`` attention and ``(B, S, C)`` scans.

All math is fp32.  On the card these functions call ``F.conv2d`` and
``torch.matmul``; callers disable TF32 first
(:func:`repro_torch.device.resolve`), or cuDNN and cuBLAS would round
the operands to TF32.
"""
from __future__ import annotations

import math

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


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """``x · rsqrt(mean x² + eps) · (1 + g)`` row-wise in fp32, cast to
    ``x.dtype`` at the end."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    y = x.float() * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def flash_attention_ref(q, k, v, causal: bool = True):
    """``(B, S, H, D)`` attention with the same heads for q, k and v: fp32
    logits over ``sqrt(D)``, the causal mask at ``finfo.min``, fp32
    softmax."""
    s, d = q.shape[1], q.shape[3]
    logits = torch.einsum("bshd,bthd->bhst", q.float(),
                          k.float()) / math.sqrt(d)
    if causal:
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", w, v.float())
    return out.to(q.dtype)


def rglru_scan_ref(a, gated, h0=None):
    """``h_t = a_t ⊙ h_{t-1} + gated_t`` over axis 1, sequentially in fp32
    (each step a rounded product, then a rounded sum); ``h0`` (B, C)
    defaults to zeros."""
    b, s, c = a.shape
    a, gated = a.float(), gated.float()
    h = torch.zeros((b, c), dtype=torch.float32, device=a.device) \
        if h0 is None else h0.float()
    out = torch.empty((b, s, c), dtype=torch.float32, device=a.device)
    for t in range(s):
        h = a[:, t] * h + gated[:, t]
        out[:, t] = h
    return out


def rglru_scan_bwd_ref(a, h, g):
    """The gradient of :func:`rglru_scan_ref` (``h0`` None) in ``a`` and
    ``gated``, from a, its output h and the output's gradient g: the
    reverse loop ``d_{S-1} = g_{S-1}``, ``d_t = g_t + a_{t+1} ⊙ d_{t+1}``
    (a rounded product, then a rounded sum), ``dgated_t = d_t``,
    ``da_t = d_t ⊙ h_{t-1}`` with ``h_{-1} = 0``; returns (da, dgated).
    Bitwise the autograd of :func:`rglru_scan_ref`: its sums of two terms
    commute and its zero-filled slices add exactly."""
    s = a.shape[1]
    a, h, g = a.float(), h.float(), g.float()
    da, db = torch.empty_like(g), torch.empty_like(g)
    d = None
    for t in range(s - 1, -1, -1):
        d = g[:, t] if d is None else g[:, t] + a[:, t + 1] * d
        db[:, t] = d
        da[:, t] = d * (h[:, t - 1] if t > 0 else torch.zeros_like(d))
    return da, db


def merged_ffn_ref(x, u, v, residual: bool = True):
    """LayerMerge rank-r residual ``x + (x@U)@V``: fp32 products and fp32
    residual add, cast to ``x.dtype`` at the end.  ``residual=False``
    gives ``(x@U)@V`` alone (the kernel's switch)."""
    h = torch.matmul(x.float(), u.float())
    y = torch.matmul(h, v.float())
    return ((x.float() + y) if residual else y).to(x.dtype)


def merged_ffn_qref(x, uq, vq, u_scale, v_scale, *, act_quant="none",
                    residual: bool = True, reduce_amax=None):
    """Dequantizing version of the quantized ``merged_ffn`` path.

    ``uq``/``vq`` are narrow (int8/fp8) with per-channel scales over the
    rank / output-embed axes.  w8a8 fake-quantizes the activation for the
    two products only — the residual adds the exact ``x`` (none with
    ``residual=False``).  ``reduce_amax``: :func:`.quant.quantize_int8`'s.
    """
    from . import quant
    u = quant.dequantize(uq, u_scale, axis=1)
    v = quant.dequantize(vq, v_scale, axis=1)
    xd = _w8a8(x, reduce_amax) if act_quant == "w8a8" else x
    h = torch.matmul(xd.float(), u)
    y = torch.matmul(h, v)
    return ((x.float() + y) if residual else y).to(x.dtype)


def _w8a8(x, reduce_amax=None):
    from . import quant
    xq, xs = quant.quantize_int8(x, reduce_amax=reduce_amax)
    return quant.dequantize(xq, xs)


def merged_conv_qref(x, wq, b, w_scale, *, stride: int = 1,
                     act_quant: str = "none", reduce_amax=None):
    """Dequantizing version of the quantized ``merged_conv`` path
    (``wq`` narrow HWIO, ``w_scale`` per-output-channel, axis 3)."""
    from . import quant
    w = quant.dequantize(wq, w_scale, axis=3)
    if act_quant == "w8a8":
        x = _w8a8(x, reduce_amax)
    return merged_conv_ref(x, w, b, stride=stride)


def depthwise_conv_qref(x, wq, b, w_scale, *, stride: int = 1,
                        groups: int | None = None,
                        act_quant: str = "none", reduce_amax=None):
    """Dequantizing version of the quantized grouped/depthwise path."""
    from . import quant
    w = quant.dequantize(wq, w_scale, axis=3)
    if act_quant == "w8a8":
        x = _w8a8(x, reduce_amax)
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
