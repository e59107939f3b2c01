"""Depthwise / grouped merged-segment convolution (VALID, stride s, NHWC):
the CUDA kernel's wrapper, its launch plan, and the grouped tile
arithmetic.

The kernel (``csrc/depthwise_conv.cu``) replaces the JAX package's Pallas
``depthwise_conv``: ``feature_group_count = G`` with weights HWIO
``(kh, kw, cin_g, G·cout_g)`` (group-major output channels), one fp32
accumulator per output element, and the same fused bias + activation
epilogue as the dense kernel.  It covers depthwise (cin_g = cout_g = 1),
channel-multiplier (cin_g = 1, cout_g > 1) and general grouped (cin_g > 1)
convolutions, and reads the HWIO weight directly, so neither the TPU
kernel's group-blocked weight relayout nor its channel padding is needed.
A thread computes a strip of outputs along Wo for a vector of 4 output
channels (one 16-byte fp32 or 32-bit int8 / fp8 load), with its weights
in registers for the strip; other channel counts and general grouped
convs take the template's scalar path.  Its quantized variant
(``w_scale``) takes int8 or fp8-e4m3 weights and an fp32 or int8 input,
and multiplies the fp32 sum by the per-channel scale before the bias.

:func:`launch_plan` picks that tile and the threads per block from the
shape and the card's SM count alone, so the arithmetic that decides
coverage runs (and is tested) on the CPU.  :func:`choose_group_block` and
:func:`choose_tiles_grouped` stay as plain Python for the JAX package's
tiled traffic model (``merged_conv.input_traffic_model`` plans depthwise
segments with them).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import cuda_build
from .merged_conv import _round8

#: Kernel launches made by :func:`depthwise_conv` in this process: fp32,
#: and the quantized variant.
launches = 0
launches_q = 0


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


#: Outputs a thread computes along Wo on the vector path (``OW_VEC`` in
#: the source).
OW_VEC = 4
#: (square kernel size, stride) pairs with a compile-time instance for
#: depthwise convs (the strip's input columns held in registers, the rows
#: unrolled): MobileNetV2's 3×3 s1 / s2 and 1×1.
FIXED_TAPS = ((3, 1), (3, 2), (1, 1))
#: Threads per block tried, largest first.
THREADS = (256, 128, 64)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One thread per (image, output row, strip of ``ow`` outputs along
    Wo, vector of ``vec`` output channels), channel vectors fastest;
    ``k_t``/``s_t`` name the compile-time instance (0: runtime kernel
    size and stride); ``threads`` per block."""
    n: int
    ho: int
    wo: int
    cout: int
    vec: int
    ow: int
    k_t: int
    s_t: int
    threads: int

    @property
    def strips(self) -> int:
        return -(-self.wo // self.ow)

    @property
    def cvecs(self) -> int:
        return self.cout // self.vec

    @property
    def total(self) -> int:
        """Threads with work."""
        return self.n * self.ho * self.strips * self.cvecs

    @property
    def blocks(self) -> int:
        return -(-self.total // self.threads)

    def args(self) -> tuple[int, int, int, int]:
        """The plan's arguments of the C entry points."""
        return (self.vec, self.k_t, self.s_t, self.threads)

    def thread_outputs(self, idx: np.ndarray):
        """(image, output row, first output column, columns, first channel)
        of each thread index: the kernel's index arithmetic, for the
        coverage tests (threads past ``total`` return early)."""
        cv, rest = idx % self.cvecs, idx // self.cvecs
        strip, rest = rest % self.strips, rest // self.strips
        ho, img = rest % self.ho, rest // self.ho
        wo0 = strip * self.ow
        return img, ho, wo0, np.minimum(self.ow, self.wo - wo0), \
            cv * self.vec


@functools.lru_cache(maxsize=1024)
def launch_plan(n: int, ho: int, wo: int, cin: int, kh: int, kw: int,
                cin_g: int, cout: int, groups: int, stride: int,
                aligned: bool = True, sms: int = 132) -> LaunchPlan:
    """The vector path (4 output channels, a strip of 4 outputs) where one
    load serves 4 output channels: cin_g = 1, Cout a multiple of 4 (and
    Cin too when each output channel has its own input channel), pointers
    aligned; else the scalar path.  Depthwise convs (cout_g = 1) with a
    square kernel of a ``FIXED_TAPS`` size and stride take its
    compile-time instance.  The most threads per block that still give
    every SM a block."""
    cout_g = cout // groups
    vec = 4 if (aligned and cin_g == 1 and cout % 4 == 0
                and (cout_g > 1 or cin % 4 == 0)) else 1
    ow = OW_VEC if vec == 4 else 1
    fixed = vec == 4 and cout_g == 1 and kh == kw \
        and (kw, stride) in FIXED_TAPS
    k_t, s_t = (kw, stride) if fixed else (0, 0)
    plans = [LaunchPlan(n, ho, wo, cout, vec, ow, k_t, s_t, threads)
             for threads in THREADS]
    return next((p for p in plans if p.blocks >= sms), plans[-1])


def depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None = None, *, stride: int = 1,
                   groups: int, activation: str | None = None,
                   w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: x (N,H,W,G·cin_g), w (kh,kw,cin_g,G·cout_g)
    → (N,Ho,Wo,G·cout_g).

    Contiguous tensors on one CUDA device; ``b`` (Cout,) fp32 or None.
    Without ``w_scale`` every operand is fp32.  With ``w_scale`` (Cout,)
    fp32 the quantized variant runs: ``w`` int8 or float8_e4m3fn, ``x``
    fp32 or int8, and the sum is multiplied by ``w_scale`` before the
    bias.  The output (fp32) is allocated here; the launch is
    asynchronous on the current stream and raises if the launch is
    refused.
    """
    global launches, launches_q
    n, h, wd, cin = x.shape
    kh, kw, cin_g, cout = w.shape
    if (groups < 1 or cin != groups * cin_g or cout % groups or stride < 1
            or h < kh or wd < kw):
        raise ValueError(f"depthwise_conv: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, groups {groups}, stride {stride}")
    if b is not None and tuple(b.shape) != (cout,):
        raise ValueError(f"depthwise_conv: bias {tuple(b.shape)} for "
                         f"Cout={cout}")
    if w_scale is None:
        cuda_build.check_operands("depthwise_conv", x, w, b)
    else:
        if tuple(w_scale.shape) != (cout,):
            raise ValueError(f"depthwise_conv: w_scale "
                             f"{tuple(w_scale.shape)} for Cout={cout}")
        f32 = (torch.float32,)
        cuda_build.check_operands(
            "depthwise_conv", x, w, w_scale, b,
            dtypes=(cuda_build.X_TYPES, cuda_build.W_TYPES, f32, f32))
    ho = (h - kh) // stride + 1
    wo = (wd - kw) // stride + 1
    y = torch.empty((n, ho, wo, cout), device=x.device, dtype=torch.float32)
    if y.numel() > 2 ** 31 - 1:
        raise ValueError("depthwise_conv: output exceeds 32-bit indexing")
    if y.numel() == 0:
        return y
    bias = None if b is None else b.data_ptr()
    act = cuda_build.ACT_CODES[activation]
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (x, w, y, b, w_scale) if t is not None)
    plan = launch_plan(n, ho, wo, cin, kh, kw, cin_g, cout, groups, stride,
                       aligned, cuda_build.sm_count(x.device))
    if w_scale is None:
        cuda_build.launch("depthwise_conv", x.device, x.data_ptr(),
                          w.data_ptr(), bias, y.data_ptr(), n, h, wd, cin,
                          kh, kw, cin_g, cout, groups, stride, ho, wo, act,
                          *plan.args())
        launches += 1
    else:
        cuda_build.launch("depthwise_conv_q", x.device, x.data_ptr(),
                          w.data_ptr(), w_scale.data_ptr(), bias,
                          y.data_ptr(), n, h, wd, cin, kh, kw, cin_g, cout,
                          groups, stride, ho, wo, act,
                          cuda_build.X_TYPES[x.dtype],
                          cuda_build.W_TYPES[w.dtype], *plan.args())
        launches_q += 1
    return y
