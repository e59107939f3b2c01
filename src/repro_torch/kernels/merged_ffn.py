"""Merged rank-r residual layer ``y = x + (x @ U) @ V``: the CUDA kernel's
wrapper and its launch plan.

The kernel (``csrc/merged_ffn.cu``) replaces the JAX package's Pallas
``merged_ffn``.  It runs as two launches of one tensor-core tile core:
phase A writes ``P = x @ U`` once into an (M, R) fp32 workspace, phase B
computes ``y = x + P @ V`` with the residual in its epilogue (or, with
the ``residual`` switch off, ``y = P @ V``: a rank's partial under a
tensor-parallel split of the rank, :mod:`repro_torch.runtime.executor`).  The TPU
kernel carried the P panel across its sequential j sweeps; here P makes
one trip through L2 instead.  fp32 operands are multiplied as 3xTF32
(hi/lo splits, fp32 sums), so the result keeps fp32 accuracy (see the
source's header for the bounds and the design).  Its quantized variant
(``u_scale``/``v_scale``) takes int8 or fp8-e4m3 ``U``/``V`` and builds
``P`` from an int8 panel ``xq`` (w8a8) or from ``x``; the residual is
always the fp32 ``x``.

:func:`launch_plan` picks each phase's tile shape and how far to split
its reduction, from the shape and the card's SM count alone, so the
arithmetic that decides coverage runs (and is tested) on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from . import cuda_build

#: Calls of :func:`merged_ffn` that launched the kernel in this process
#: (one per unit: each call makes the two launches of phases A and B):
#: fp32, and the quantized variant.
launches = 0
launches_q = 0

#: k-slice depth of the kernel (``BK`` in the source).
BK = 32
#: Tile shapes of the source (``Small`` and ``Large``): rows, columns,
#: blocks resident per SM, most splits of the reduction (cluster size).
SMALL = (16, 64, 5, 16)
LARGE = (128, 128, 1, 8)
#: Up to this many rows a phase is bound by the bytes of U or V: the small
#: tile, and the reduction split until the card is full.
SMALL_M = 64
#: Blocks resident at once on an H100 SXM (132 SMs) when they launch as
#: clusters of 1, 2, ... splits: ``cudaOccupancyMaxActiveClusters`` times
#: the cluster size, for the fp32 instances (the C entry
#: ``merged_ffn_slots``; ``chip_smoke.py`` prints the card's and compares).
#: A cluster must fit inside one GPC, so sizes that do not divide a GPC's
#: SMs leave some idle: 6 splits of the large tile fit 102 blocks, 5 fit
#: 110.
H100_SLOTS = {
    SMALL: (660, 660, 609, 616, 620, 606, 588, 616, 540, 580, 561, 528, 546,
            518, 555, 560),
    LARGE: (132, 132, 117, 120, 110, 102, 105, 120)}
#: The cost model's overheads, in k-slices: filling the pipeline and the
#: epilogue, and the cluster reduction of a split tile.
_FILL, _REDUCE = 2, 2


def _slots(tile, splits: int, sms: int) -> int:
    """Blocks of ``tile`` resident at once in clusters of ``splits``."""
    if sms == 132:
        return H100_SLOTS[tile][splits - 1]
    return max(sms * tile[2] // splits, 1) * splits


@dataclasses.dataclass(frozen=True)
class PhasePlan:
    """One product ``(rows, depth) @ (depth, cols)``: block tile ``bm`` ×
    ``bn``; ``splits`` blocks (one cluster) share each output tile, split
    ``s`` summing ``k`` in ``[s·k_chunk, (s+1)·k_chunk)``."""
    rows: int
    cols: int
    depth: int
    bm: int
    bn: int
    splits: int
    k_chunk: int

    @property
    def grid(self) -> tuple[int, int, int]:
        """(splits, column tiles, row tiles): the launch's grid."""
        return (self.splits, -(-self.cols // self.bn),
                -(-self.rows // self.bm))

    @property
    def blocks(self) -> int:
        s, ny, nz = self.grid
        return s * ny * nz

    def k_range(self, split: int) -> tuple[int, int]:
        lo = split * self.k_chunk
        return lo, min(self.depth, lo + self.k_chunk)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Phase A (``P = xq @ U``, (M, R) over D) and phase B (``y = x +
    P @ V``, (M, D) over R), and the fp32 workspace P's shape."""
    a: PhasePlan
    b: PhasePlan

    @property
    def workspace(self) -> tuple[int, int]:
        return (self.a.rows, self.a.cols)

    def args(self) -> tuple[int, ...]:
        """The plan's arguments of the C entry points."""
        return (self.a.bm, self.a.bn, self.a.splits, self.a.k_chunk,
                self.b.bm, self.b.bn, self.b.splits, self.b.k_chunk)


def _phase(rows: int, cols: int, depth: int, sms: int) -> PhasePlan:
    """The tile by ``rows``; the split that finishes soonest under a
    wave model: blocks run as many at a time as fit in clusters of the
    split (:func:`_slots`), each taking its k-slices plus the fixed
    overheads."""
    tile = SMALL if rows <= SMALL_M else LARGE
    bm, bn, _, max_splits = tile
    tiles = -(-rows // bm) * -(-cols // bn)
    slices = -(-depth // BK)
    best = (float("inf"), 1, max(slices, 1))
    for s in range(1, min(max_splits, slices) + 1):
        chunk = -(-slices // s)
        s_eff = -(-slices // chunk)
        waves = -(-tiles * s_eff // _slots(tile, s_eff, sms))
        cost = waves * (chunk + _FILL + (_REDUCE if s_eff > 1 else 0))
        if cost < best[0]:
            best = (cost, s_eff, chunk)
    _, splits, chunk = best
    return PhasePlan(rows, cols, depth, bm, bn, splits, chunk * BK)


@functools.lru_cache(maxsize=1024)
def launch_plan(m: int, d: int, r: int, sms: int = 132) -> LaunchPlan:
    """The launch plan of x (M, D), U (D, R), V (R, D) on a card with
    ``sms`` SMs (an H100 SXM has 132)."""
    return LaunchPlan(_phase(m, r, d, sms), _phase(m, d, r, sms))


def merged_ffn(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
               u_scale: torch.Tensor | None = None,
               v_scale: torch.Tensor | None = None,
               xq: torch.Tensor | None = None,
               residual: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel: x (M, D), u (D, R), v (R, D) → (M, D).

    Contiguous tensors on one CUDA device.  Without scales every operand
    is fp32.  With ``u_scale`` (R,) and ``v_scale`` (D,) fp32 the
    quantized variant runs: ``u``/``v`` int8 or float8_e4m3fn, ``P`` built
    from ``xq`` (M, D) int8 (w8a8; its scale folded into ``u_scale``) or
    from ``x`` when ``xq`` is None, ``y = x + ((xq @ u)·u_scale) @ v ·
    v_scale``.  The output (fp32) and the (M, R) fp32 workspace of P are
    allocated here; the two launches are asynchronous on the current
    stream and raise if either is refused.  ``residual=False`` leaves the
    ``x`` term out of phase B's epilogue (``y = P @ V``): one rank's
    partial of a split over the rank, whose sum adds ``x`` once.
    """
    global launches, launches_q
    if x.ndim != 2 or u.ndim != 2 or v.ndim != 2:
        raise ValueError(f"merged_ffn: x {tuple(x.shape)}, u "
                         f"{tuple(u.shape)}, v {tuple(v.shape)} must be 2-D")
    m, d = x.shape
    r = u.shape[1]
    if u.shape[0] != d or tuple(v.shape) != (r, d):
        raise ValueError(f"merged_ffn: x {tuple(x.shape)}, u "
                         f"{tuple(u.shape)}, v {tuple(v.shape)}")
    quant = u_scale is not None
    if quant != (v_scale is not None) or (xq is not None and not quant):
        raise ValueError("merged_ffn: pass u_scale and v_scale together, "
                         "and xq only with them")
    if not quant:
        cuda_build.check_operands("merged_ffn", x, u, v)
    else:
        if tuple(u_scale.shape) != (r,) or tuple(v_scale.shape) != (d,):
            raise ValueError(f"merged_ffn: u_scale {tuple(u_scale.shape)}, "
                             f"v_scale {tuple(v_scale.shape)} for R={r}, "
                             f"D={d}")
        if xq is not None and xq.shape != x.shape:
            raise ValueError(f"merged_ffn: xq {tuple(xq.shape)} for x "
                             f"{tuple(x.shape)}")
        f32, wts = (torch.float32,), cuda_build.W_TYPES
        cuda_build.check_operands(
            "merged_ffn", x, xq, u, v, u_scale, v_scale,
            dtypes=(f32, cuda_build.X_TYPES, wts, wts, f32, f32))
        if u.dtype != v.dtype:
            raise TypeError(f"merged_ffn: u {u.dtype} and v {v.dtype} differ")
    if m * r > cuda_build.INT32_MAX:
        raise ValueError(f"merged_ffn: the ({m}, {r}) workspace of P exceeds "
                         "the kernel's 32-bit indexing")
    y = torch.empty((m, d), device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    plan = launch_plan(m, d, r, cuda_build.sm_count(x.device))
    if max(plan.a.grid[1:] + plan.b.grid[1:]) > 65535:
        raise ValueError(f"merged_ffn: M = {m}, D = {d}, R = {r} exceed the "
                         "kernel's grid (65535 tiles a side)")
    p = torch.empty(plan.workspace, device=x.device, dtype=torch.float32)
    if not quant:
        cuda_build.launch("merged_ffn", x.device, x.data_ptr(), u.data_ptr(),
                          v.data_ptr(), y.data_ptr(), p.data_ptr(), m, d, r,
                          *plan.args(), int(bool(residual)))
        launches += 1
        return y
    panel = x if xq is None else xq
    cuda_build.launch("merged_ffn_q", x.device, x.data_ptr(),
                      panel.data_ptr(), u.data_ptr(), v.data_ptr(),
                      u_scale.data_ptr(), v_scale.data_ptr(), y.data_ptr(),
                      p.data_ptr(), m, d, r, cuda_build.X_TYPES[panel.dtype],
                      cuda_build.W_TYPES[u.dtype], *plan.args(),
                      int(bool(residual)))
    launches_q += 1
    return y
