"""Merged-segment convolution (VALID, stride s, NHWC): the CUDA kernel's
wrapper, its launch plan, and the tile/traffic arithmetic of the TPU
kernel that the cost model prices with.

The kernel (``csrc/merged_conv.cu``) replaces the JAX package's Pallas
``merged_conv``: an implicit GEMM over the kh·kw·Cin reduction on the
tensor cores at fp32 accuracy (3xTF32 for fp32 operands, 2xTF32 for fp32
× narrow, the int8 mma summed in int32 for w8a8), fed by a cp.async ring
that gathers the strided NHWC window in place, with a fused scale, bias
and activation epilogue.  The phase-major relayout the TPU kernel needed
for contiguous DMA windows is not carried over.  Its quantized variant
(``w_scale``) takes int8 or fp8-e4m3 weights and an fp32 or int8 input,
and multiplies the fp32 sum by the per-channel scale before the bias.

:func:`launch_plan` picks the instance (tile shape, copy widths, the
dense 1×1 panel, the int8 mma) and how far to split the reduction,
from the shape and the card's SM count alone, so the arithmetic that
decides coverage runs (and is tested) on the CPU.

The arithmetic below it — :func:`phase_extents`, :func:`choose_tiles`,
:func:`input_traffic_model` — is the JAX package's tiled traffic model
(one read of the image plus the halo re-read at tile seams, plus the
relayout a strided segment pays), kept as plain Python for
``core.latency.conv2d_cost`` when it is given a tile budget: the parity
tests pass the JAX package's own budget to reproduce its costs bit for
bit.  It does not describe the CUDA kernel, and the port's default costs
do not use it.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from . import cuda_build

#: Kernel launches made by :func:`merged_conv` in this process: fp32, and
#: the quantized variant.
launches = 0
launches_q = 0


#: k-slice depth of the kernel (``BK`` in the source).
BK = 32
#: Most splits of the reduction: one thread-block cluster (portable size).
MAX_SPLITS = 8
#: The int8 mma sums |code·code| <= 2^14 per term in int32: K below this.
S8_MAX_K = 2 ** 17
#: The source's tiles (rows, columns) and, for each, its threads, ring
#: stages and blocks resident per SM (its launch bound).
N16, N32, N64, WIDE = (128, 16), (128, 32), (64, 64), (128, 128)
TILES = {N16: (128, 3, 3), N32: (128, 3, 3), N64: (128, 4, 3),
         WIDE: (256, 4, 1)}
#: Below this reduction depth a dense 1×1 panel, or a conv with Cout <= 32,
#: takes the 128 × 16 tile.
NARROW_K = 512
#: The 128 × 128 tile is a candidate from this reduction depth on.
WIDE_K = 2048
#: A wider tile is taken if its plan gives at least this many blocks per SM.
BLOCKS_PER_SM = 2
#: The split model's overheads, in k-slices: filling the ring and the
#: epilogue, and the cluster reduction of a split tile.
_FILL, _REDUCE = 2, 1


def _pad(n: int, tile: int) -> int:
    return -(-n // tile) * tile


def smem_bytes(tile, x_bytes: int, w_bytes: int) -> int:
    """Dynamic shared memory of an instance (``Layout::BYTES``): the ring
    of A (rows of 32 + 8 floats or 32 + 16 bytes) and B (BN + 4 floats or
    BN + 16 bytes) slices, the block's row bases, or the partial tile of
    a split if that is larger."""
    bm, bn = tile
    stages = TILES[tile][1]
    a_ld = BK + (8 if x_bytes == 4 else 16)
    b_ld = bn + (4 if w_bytes == 4 else 16)
    pipe = stages * (bm * a_ld * x_bytes + BK * b_ld * w_bytes)
    return max(pipe + bm * 4, bm * (bn + 4) * 4)


def copy_width(elems: int, itemsize: int, aligned: bool) -> int:
    """Bytes a copy of rows of ``elems`` elements: 16 where a row holds
    whole 16-byte runs and the pointer is aligned; for narrow types 8 or
    4 where those divide a row; else one element."""
    if aligned:
        for v in ((16,) if itemsize == 4 else (16, 8, 4)):
            if elems * itemsize % v == 0:
                return v
    return itemsize


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One conv as a product (M, K) @ (K, Cout): block tile ``bm`` ×
    ``bn``; ``splits`` blocks (one cluster, consecutive along the grid's
    x) share each output tile, split ``s`` summing ``k`` in
    ``[s·k_chunk, (s+1)·k_chunk)``; the input and weight copied in
    ``a_vec``- and ``b_vec``-byte runs; ``dense``: a 1×1 stride-1 panel
    (no gather); ``s8``: the int8 mma."""
    m: int
    k: int
    cout: int
    bm: int
    bn: int
    splits: int
    k_chunk: int
    a_vec: int
    b_vec: int
    dense: bool
    s8: bool

    @property
    def grid(self) -> tuple[int, int]:
        """(splits · row tiles, column tiles): the launch's grid."""
        return (self.splits * -(-self.m // self.bm), -(-self.cout // self.bn))

    @property
    def blocks(self) -> int:
        gx, gy = self.grid
        return gx * gy

    def k_range(self, split: int) -> tuple[int, int]:
        lo = split * self.k_chunk
        return lo, min(self.k, lo + self.k_chunk)

    def block_outputs(self, bx: int, by: int):
        """(rows, columns, reduction indices) that block (bx, by) sums:
        the kernel's index arithmetic, for the coverage tests."""
        split, tile = bx % self.splits, bx // self.splits
        m0, n0 = tile * self.bm, by * self.bn
        return ((m0, min(self.m, m0 + self.bm)),
                (n0, min(self.cout, n0 + self.bn)), self.k_range(split))

    def args(self) -> tuple[int, ...]:
        """The plan's arguments of the C entry points."""
        return (self.bm, self.bn, self.splits, self.k_chunk, self.a_vec,
                self.b_vec, int(self.dense), int(self.s8))


#: Bytes of an element by the C entry points' type codes (``x_type``,
#: ``w_type``; 0 is fp32).
_ITEMSIZE = {0: 4, 1: 1, 2: 1}


def plan_as_block(whole: tuple[int, int], n: int, h: int, w: int, cin: int,
                  kh: int, kw: int, cout: int, stride: int, x_type: int = 0,
                  w_type: int = 0, aligned: bool = True,
                  sms: int = 132) -> LaunchPlan:
    """The launch plan of a block (``n`` rows, ``cout`` channels) of the
    product of batch ``whole[0]`` and ``whole[1]`` channels: the whole
    product's tile, splits and k-chunk — which fix the order each output
    sums its reduction in — over the block's rows and columns, with the
    block's weight copy width."""
    plan = launch_plan(whole[0], h, w, cin, kh, kw, whole[1], stride, x_type,
                       w_type, aligned, sms)
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    return dataclasses.replace(
        plan, m=n * ho * wo, cout=cout,
        b_vec=copy_width(cout, _ITEMSIZE[w_type], aligned))


def plan_for_tile(tile, n: int, h: int, w: int, cin: int, kh: int, kw: int,
                  cout: int, stride: int, x_type: int = 0, w_type: int = 0,
                  aligned: bool = True, sms: int = 132) -> LaunchPlan:
    """The plan of these operands on ``tile``: the split that finishes
    soonest under a wave model (blocks run as many at a time as the
    tile's launch bound keeps resident, each taking its k-slices plus the
    fixed overheads), the copy widths, the dense panel, the int8 mma."""
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    m, k = n * ho * wo, kh * kw * cin
    bm, bn = tile
    tiles = -(-m // bm) * -(-cout // bn)
    slots = sms * TILES[tile][2]
    slices = -(-k // BK)
    best = (float("inf"), 1, max(slices, 1))
    for s in range(1, min(MAX_SPLITS, slices) + 1):
        chunk = -(-slices // s)
        s_eff = -(-slices // chunk)
        waves = -(-tiles * s_eff // slots)
        cost = waves * (chunk + _FILL + (_REDUCE if s_eff > 1 else 0))
        if cost < best[0]:
            best = (cost, s_eff, chunk)
    _, splits, chunk = best
    return LaunchPlan(
        m, k, cout, bm, bn, splits, chunk * BK,
        copy_width(cin, _ITEMSIZE[x_type], aligned),
        copy_width(cout, _ITEMSIZE[w_type], aligned),
        kh == kw == 1 and stride == 1,
        x_type == 1 and w_type == 1 and k < S8_MAX_K)


@functools.lru_cache(maxsize=4096)
def launch_plan(n: int, h: int, w: int, cin: int, kh: int, kw: int,
                cout: int, stride: int, x_type: int = 0, w_type: int = 0,
                aligned: bool = True, sms: int = 132) -> LaunchPlan:
    """The launch plan of x (n, h, w, cin) ⋆ w (kh, kw, cin, cout) at
    ``stride`` on a card with ``sms`` SMs (an H100 SXM has 132).  Types
    by the C codes (x: 0 fp32, 1 int8; w: 0 fp32, 1 int8, 2 e4m3);
    ``aligned``: x and w start on 16 bytes.

    A shallow reduction (K < ``NARROW_K``) waits on memory: where the
    input is cheap to read again for each column tile (a dense 1×1
    panel, or at most two tiles for Cout <= 32) it takes 128 × 16, the
    most blocks and loads in flight.  Otherwise the widest tile (128 ×
    128 from ``WIDE_K`` on, then 64 × 64 and 128 × 32, each where it pads
    Cout by at most a third) whose plan gives every SM ``BLOCKS_PER_SM``
    blocks: wider tiles reuse each fragment over more products, which
    pays where the reduction is deep.  Else 128 × 16.  The rest of the
    plan by :func:`plan_for_tile`."""
    args = (n, h, w, cin, kh, kw, cout, stride, x_type, w_type, aligned, sms)
    k = kh * kw * cin
    if k < NARROW_K and ((kh == kw == 1 and stride == 1) or cout <= 32):
        return plan_for_tile(N16, *args)
    wide = (WIDE,) if k >= WIDE_K else ()
    for tile in wide + (N64, N32):
        if 3 * _pad(cout, tile[1]) > 4 * cout:
            continue
        plan = plan_for_tile(tile, *args)
        if plan.blocks >= BLOCKS_PER_SM * sms:
            return plan
    return plan_for_tile(N16, *args)


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
                *, stride: int = 1, activation: str | None = None,
                w_scale: torch.Tensor | None = None,
                plan_as: tuple[int, int] | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: x (N,H,W,Cin), w (kh,kw,Cin,Cout) → (N,Ho,Wo,Cout).

    Contiguous tensors on one CUDA device; ``b`` (Cout,) fp32 or None.
    Without ``w_scale`` every operand is fp32.  With ``w_scale`` (Cout,)
    fp32 the quantized variant runs: ``w`` int8 or float8_e4m3fn, ``x``
    fp32 or int8, and the sum is multiplied by ``w_scale`` before the
    bias.  The output (fp32) is allocated here; the launch is
    asynchronous on the current stream and raises if the launch is
    refused.

    ``plan_as`` ``(n, cout)``: x and w are a block (a rank's rows and
    output channels under a mesh) of a product of batch ``n`` and ``cout``
    channels; the launch takes that product's tile, splits and k-chunk
    (:func:`plan_as_block`), so every output sums its k-slices in the
    order the whole product's launch does: bitwise the single device's.
    """
    global launches, launches_q
    n, h, wd, cin = x.shape
    kh, kw, cin_w, cout = w.shape
    if cin_w != cin or stride < 1 or h < kh or wd < kw:
        raise ValueError(f"merged_conv: x {tuple(x.shape)}, w {tuple(w.shape)},"
                         f" stride {stride}")
    if b is not None and tuple(b.shape) != (cout,):
        raise ValueError(f"merged_conv: bias {tuple(b.shape)} for Cout={cout}")
    if w_scale is None:
        cuda_build.check_operands("merged_conv", x, w, b)
    else:
        if tuple(w_scale.shape) != (cout,):
            raise ValueError(f"merged_conv: w_scale {tuple(w_scale.shape)} "
                             f"for Cout={cout}")
        f32 = (torch.float32,)
        cuda_build.check_operands(
            "merged_conv", x, w, w_scale, b,
            dtypes=(cuda_build.X_TYPES, cuda_build.W_TYPES, f32, f32))
    ho = (h - kh) // stride + 1
    wo = (wd - kw) // stride + 1
    y = torch.empty((n, ho, wo, cout), device=x.device, dtype=torch.float32)
    if y.numel() > 2 ** 31 - 1:
        raise ValueError("merged_conv: output exceeds 32-bit indexing")
    if y.numel() == 0:
        return y
    bias = None if b is None else b.data_ptr()
    act = cuda_build.ACT_CODES[activation]
    x_type = 0 if w_scale is None else cuda_build.X_TYPES[x.dtype]
    w_type = 0 if w_scale is None else cuda_build.W_TYPES[w.dtype]
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    if plan_as is None:
        plan = launch_plan(n, h, wd, cin, kh, kw, cout, stride, x_type,
                           w_type, aligned, cuda_build.sm_count(x.device))
    else:
        plan = plan_as_block(plan_as, n, h, wd, cin, kh, kw, cout, stride,
                             x_type, w_type, aligned,
                             cuda_build.sm_count(x.device))
    if plan.grid[1] > 65535:
        raise ValueError(f"merged_conv: Cout = {cout} exceeds the kernel's "
                         "grid (65535 column tiles)")
    if w_scale is None:
        cuda_build.launch("merged_conv", x.device, x.data_ptr(), w.data_ptr(),
                          bias, y.data_ptr(), n, h, wd, cin, kh, kw, cout,
                          stride, ho, wo, act, *plan.args())
        launches += 1
    else:
        cuda_build.launch("merged_conv_q", x.device, x.data_ptr(),
                          w.data_ptr(), w_scale.data_ptr(), bias, y.data_ptr(),
                          n, h, wd, cin, kh, kw, cout, stride, ho, wo, act,
                          x_type, w_type, *plan.args())
        launches_q += 1
    return y
