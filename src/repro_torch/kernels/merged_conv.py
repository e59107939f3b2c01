"""Merged-segment convolution (VALID, stride s, NHWC): the CUDA kernel's
wrapper plus the tile/traffic arithmetic the cost model prices with.

The kernel (``csrc/merged_conv.cu``) replaces the JAX package's Pallas
``merged_conv``: an implicit GEMM over the kh·kw·Cin reduction with an
fp32 accumulator and a fused bias + activation epilogue.  It reads the
NHWC input with stride s directly, so the phase-major relayout the TPU
kernel needed for contiguous DMA windows is not carried over.

The arithmetic below — :func:`phase_extents`, :func:`choose_tiles`,
:func:`input_traffic_model` — is the JAX package's tiled traffic model
(one read of the image plus the halo re-read at tile seams, plus the
relayout a strided segment pays), kept as plain Python for
``core.latency.conv2d_cost`` when it is given a tile budget: the parity
tests pass the JAX package's own budget to reproduce its costs bit for
bit.  It does not describe the CUDA kernel, and the port's default costs
do not use it.
"""
from __future__ import annotations

import torch

from . import cuda_build

#: Kernel launches made by :func:`merged_conv` in this process.
launches = 0


def phase_extents(kh: int, kw: int, stride: int) -> tuple[int, int, int, int]:
    """``(pʜ, p𝑤, δʜ, δ𝑤)``: phases touched per spatial axis (``min(s, k)``)
    and per-phase halo extents (``(k−1)//s``)."""
    s = max(stride, 1)
    return min(s, kh), min(s, kw), (kh - 1) // s, (kw - 1) // s


def _round8(t: int, cap: int) -> int:
    """Clamp a tile extent to [1, cap], preferring multiples of 8."""
    t = max(min(t, cap), 1)
    if t < cap and t > 8:
        t -= t % 8
    return t


def choose_tiles(h: int, w: int, cin: int, kh: int, kw: int, stride: int,
                 itemsize: int, bcout: int = 128, *,
                 budget_bytes: float) -> tuple[int, int]:
    """2-D ``(tile_ho, tile_wo)`` planner over a per-tile working set.

    Accounts the double-buffered input window ``2·(s·tho + k_h − 1)·
    (s·two + k_w − 1)·Cin·itemsize``, the weight block ``k_h·k_w·Cin·
    bCout·itemsize`` and the fp32 accumulator plus output block
    ``tho·two·bCout·(4 + itemsize)``.  Starts from the full output width
    and grows the row tile; only when one full-width output row overflows
    does it shrink ``tile_wo`` with ``tile_ho = 1``.
    """
    s = max(stride, 1)
    ho = max((h - kh) // s + 1, 1)
    wo = max((w - kw) // s + 1, 1)
    fixed = kh * kw * cin * bcout * itemsize          # weight block
    acc_b = bcout * (4 + itemsize)                    # per output element

    shi1 = s + kh - 1
    a_w = 2 * shi1 * s * cin * itemsize + acc_b
    b_w = fixed + 2 * shi1 * (kw - 1) * cin * itemsize
    if a_w * wo + b_w > budget_bytes:
        tile_wo = int((budget_bytes - b_w) // a_w)
        return 1, _round8(tile_wo, wo)

    swi = s * wo + kw - 1
    a_h = 2 * s * swi * cin * itemsize + wo * acc_b
    b_h = fixed + 2 * (kh - 1) * swi * cin * itemsize
    tile_ho = int((budget_bytes - b_h) // a_h)
    return _round8(tile_ho, ho), wo


def input_traffic_model(h: int, w: int, cin: int, kh: int, kw: int,
                        stride: int, itemsize: int,
                        tile_ho: int | None = None,
                        tile_wo: int | None = None,
                        bcout: int = 128,
                        groups: int = 1, *,
                        budget_bytes: float) -> dict[str, float]:
    """Per-image input bytes of a tiled merged conv.

    ``dma_bytes``: every tile's phase-major halo'd window read once (one
    image read plus the halo rows/cols re-read at tile seams); the total
    is group-blocking invariant, ``groups`` only selects the grouped tile
    planner.  ``relayout_bytes``: the phase-major transpose a strided
    segment pays (read + write of the padded image, zero at stride 1).
    """
    s = max(stride, 1)
    if tile_ho is None or tile_wo is None:
        if groups > 1:
            from .depthwise_conv import choose_tiles_grouped
            from .ops import channel_tile
            a_ho, a_wo = choose_tiles_grouped(
                h, w, 1, 1, kh, kw, s, itemsize,
                bgroups=channel_tile(groups, None), budget_bytes=budget_bytes)
        else:
            a_ho, a_wo = choose_tiles(h, w, cin, kh, kw, s, itemsize, bcout,
                                      budget_bytes=budget_bytes)
        tile_ho = tile_ho or a_ho
        tile_wo = tile_wo or a_wo
    ho = max((h - kh) // s + 1, 1)
    wo = max((w - kw) // s + 1, 1)
    tile_ho = max(1, min(tile_ho, ho))
    tile_wo = max(1, min(tile_wo, wo))
    n_th, n_tw = -(-ho // tile_ho), -(-wo // tile_wo)
    ph, pw, dh, dw = phase_extents(kh, kw, s)
    tile_elems = ph * pw * (tile_ho + dh) * (tile_wo + dw)
    dma = n_th * n_tw * tile_elems * cin * itemsize
    relayout = 0.0
    if s > 1:
        hs = max(n_th * tile_ho + dh, -(-h // s))
        ws = max(n_tw * tile_wo + dw, -(-w // s))
        relayout = 2.0 * s * hs * s * ws * cin * itemsize
    return {"dma_bytes": float(dma), "relayout_bytes": float(relayout)}


def merged_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                *, stride: int = 1, activation: str | None = None
                ) -> torch.Tensor:
    """Launch the CUDA kernel: x (N,H,W,Cin), w (kh,kw,Cin,Cout) → (N,Ho,Wo,Cout).

    fp32, contiguous tensors on one CUDA device; ``b`` (Cout,) or None.
    The output is allocated here; the launch is asynchronous on the
    current stream and raises if the launch is refused.
    """
    global launches
    n, h, wd, cin = x.shape
    kh, kw, cin_w, cout = w.shape
    if cin_w != cin or stride < 1 or h < kh or wd < kw:
        raise ValueError(f"merged_conv: x {tuple(x.shape)}, w {tuple(w.shape)},"
                         f" stride {stride}")
    if b is not None and tuple(b.shape) != (cout,):
        raise ValueError(f"merged_conv: bias {tuple(b.shape)} for Cout={cout}")
    cuda_build.check_operands("merged_conv", x, w, b)
    ho = (h - kh) // stride + 1
    wo = (wd - kw) // stride + 1
    y = torch.empty((n, ho, wo, cout), device=x.device, dtype=torch.float32)
    if y.numel() > 2 ** 31 - 1:
        raise ValueError("merged_conv: output exceeds 32-bit indexing")
    if y.numel() == 0:
        return y
    cuda_build.launch(
        "merged_conv", x.device, x.data_ptr(), w.data_ptr(),
        None if b is None else b.data_ptr(), y.data_ptr(), n, h, wd, cin, kh,
        kw, cout, stride, ho, wo, cuda_build.ACT_CODES[activation])
    launches += 1
    return y
