"""Depthwise / grouped merged-segment convolution (VALID, stride s, NHWC):
the CUDA kernel's wrapper plus the grouped tile arithmetic.

The kernel (``csrc/depthwise_conv.cu``) replaces the JAX package's Pallas
``depthwise_conv``: ``feature_group_count = G`` with weights HWIO
``(kh, kw, cin_g, G·cout_g)`` (group-major output channels), one fp32
accumulator per output element, and the same fused bias + activation
epilogue as the dense kernel.  It covers depthwise (cin_g = cout_g = 1),
channel-multiplier (cin_g = 1, cout_g > 1) and general grouped (cin_g > 1)
convolutions, and reads the HWIO weight directly, so neither the TPU
kernel's group-blocked weight relayout nor its channel padding is needed.

:func:`choose_group_block` and :func:`choose_tiles_grouped` stay as plain
Python for the JAX package's tiled traffic model
(``merged_conv.input_traffic_model`` plans depthwise segments with them).
"""
from __future__ import annotations

import torch

from . import cuda_build
from .merged_conv import _round8

#: Kernel launches made by :func:`depthwise_conv` in this process.
launches = 0


def choose_group_block(groups: int, cin_g: int, cout_g: int,
                       requested: int | None = None) -> int:
    """Groups per tile: a channel tile from ``ops.channel_tile`` for
    depthwise-shaped convs (``cin_g == 1``), one group otherwise."""
    if cin_g == 1:
        from .ops import channel_tile                 # ops imports us
        bc = channel_tile(groups * cout_g, requested)
        return max(1, bc // cout_g)
    return 1


def choose_tiles_grouped(h: int, w: int, cin_g: int, cout_g: int,
                         kh: int, kw: int, stride: int, itemsize: int,
                         bgroups: int = 1, *, budget_bytes: float
                         ) -> tuple[int, int]:
    """``(tile_ho, tile_wo)`` planner for a grouped tile's working set:
    the double-buffered input window holds ``bgroups·cin_g`` channels, the
    weight block is ``k_h·k_w·bgroups·cin_g·cout_g`` and the fp32
    accumulator plus output block ``tho·two·bgroups·cout_g·(4+itemsize)``
    (same two branches as ``merged_conv.choose_tiles``)."""
    s = max(stride, 1)
    ho = max((h - kh) // s + 1, 1)
    wo = max((w - kw) // s + 1, 1)
    bcin = bgroups * cin_g
    fixed = kh * kw * bgroups * cin_g * cout_g * itemsize   # weight block
    acc_b = bgroups * cout_g * (4 + itemsize)               # per output elem

    shi1 = s + kh - 1
    a_w = 2 * shi1 * s * bcin * itemsize + acc_b
    b_w = fixed + 2 * shi1 * (kw - 1) * bcin * itemsize
    if a_w * wo + b_w > budget_bytes:
        tile_wo = int((budget_bytes - b_w) // a_w)
        return 1, _round8(tile_wo, wo)

    swi = s * wo + kw - 1
    a_h = 2 * s * swi * bcin * itemsize + wo * acc_b
    b_h = fixed + 2 * (kh - 1) * swi * bcin * itemsize
    tile_ho = int((budget_bytes - b_h) // a_h)
    return _round8(tile_ho, ho), wo


def depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None = None, *, stride: int = 1,
                   groups: int, activation: str | None = None
                   ) -> torch.Tensor:
    """Launch the CUDA kernel: x (N,H,W,G·cin_g), w (kh,kw,cin_g,G·cout_g)
    → (N,Ho,Wo,G·cout_g).

    fp32, contiguous tensors on one CUDA device; ``b`` (Cout,) or None.
    The output is allocated here; the launch is asynchronous on the
    current stream and raises if the launch is refused.
    """
    global launches
    n, h, wd, cin = x.shape
    kh, kw, cin_g, cout = w.shape
    if (groups < 1 or cin != groups * cin_g or cout % groups or stride < 1
            or h < kh or wd < kw):
        raise ValueError(f"depthwise_conv: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, groups {groups}, stride {stride}")
    if b is not None and tuple(b.shape) != (cout,):
        raise ValueError(f"depthwise_conv: bias {tuple(b.shape)} for "
                         f"Cout={cout}")
    cuda_build.check_operands("depthwise_conv", x, w, b)
    ho = (h - kh) // stride + 1
    wo = (wd - kw) // stride + 1
    y = torch.empty((n, ho, wo, cout), device=x.device, dtype=torch.float32)
    if y.numel() > 2 ** 31 - 1:
        raise ValueError("depthwise_conv: output exceeds 32-bit indexing")
    if y.numel() == 0:
        return y
    cuda_build.launch(
        "depthwise_conv", x.device, x.data_ptr(), w.data_ptr(),
        None if b is None else b.data_ptr(), y.data_ptr(), n, h, wd, cin, kh,
        kw, cin_g, cout, groups, stride, ho, wo,
        cuda_build.ACT_CODES[activation])
    launches += 1
    return y
