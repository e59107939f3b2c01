"""Causal (or full) softmax attention, forward: the CUDA kernels' wrapper
and their launch plans.

Both kernels replace the JAX package's Pallas ``flash_attention``: online
softmax over kv tiles, fp32 accumulation, kv tiles above the diagonal
skipped under the causal mask and the final division by
``max(l, 1e-30)``.  The TPU kernel's running max, normalizer and
accumulator lived in VMEM across its sequential kv grid axis; here they
live in registers across a kv loop inside one block.  Both read the
(B, S, H, D) layout in place, and k / v with fewer heads (KVH dividing H;
query head h reads kv head h // (H / KVH)): a block's query rows are the
(s, head) pairs of one (batch, kv head), s-major, so grouped and
multi-query attention load each K/V tile once for the group.

- The fp32 body (``csrc/flash_attention.cu``): both products on the
  tensor cores as 3xTF32 ``mma.sync`` (hi/lo splits, fp32 sums), so the
  result keeps fp32 accuracy; K/V tiles through a cp.async ring.
- The bf16 body (``csrc/flash_attention_bf16.cu``), a Hopper kernel of its
  own: q·kᵀ and p·v on ``wgmma`` (bf16 in, fp32 out), p split into three
  bf16 pieces that sum to it exactly, so p stays fp32 into p·v as the TPU
  kernel keeps it; K/V tiles of 64 keys by TMA into an mbarrier ring,
  fed by a producer warpgroup beside two consumer warpgroups of 64 query
  rows, or by a lone consumer warpgroup itself; o rounded once, at its
  store.

:func:`launch_plan` picks the block shape of each body (the fp32 body's
row groups and column split; the bf16 body's consumer warpgroups and
column split) from the shape and the card's SM count alone, so the
arithmetic that decides coverage runs (and is tested) on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import cuda_build

#: Kernel launches made by :func:`flash_attention` in this process: the
#: fp32 body and the bf16 body.
launches = 0
launches_bf16 = 0

#: Largest head dim the kernel takes.
MAX_HEAD_DIM = 256
#: The head-dim tiles instantiated for each element size in bytes: the
#: bf16 body's swizzled chunks are 64 columns wide.
HEAD_DIM_TILES = {4: (32, 64, 128, 256), 2: (64, 128, 256)}
#: The dtypes the kernel takes: fp32 and bf16, one C entry point each.
ENTRY = {torch.float32: "flash_attention",
         torch.bfloat16: "flash_attention_bf16"}
#: K/V tiles in flight in the fp32 body (``STAGES`` in its source).
STAGES = 3
#: Row groups of 16 query rows a block may hold, largest first, by head-dim
#: tile (8 warps at most: D 256 splits q·kᵀ over 4 warps a row group).
ROW_GROUPS = {32: (4, 2, 1), 64: (4, 2, 1), 128: (4, 2, 1), 256: (2, 1)}
#: Fewest warps a block holds (its warps share each K/V tile): at a short
#: prefill, fewer blocks of 4 warps ran faster than more blocks of one.
MIN_WARPS = 4

#: The bf16 body's constants, as ``csrc/flash_attention_bf16.cu`` names
#: them: keys a kv tile, query rows a consumer warpgroup, bf16 columns of
#: a swizzled chunk, the stages of the K/V ring, a block's most shared
#: memory on the H100, each of two blocks' on one SM, and the bytes of
#: alignment slack and barriers.
BKV, ROWS, CHUNK = 64, 64, 64
MIN_STAGES, MAX_STAGES = 2, 4
SMEM_LIMIT, SMEM_HALF, SMEM_EXTRA = 232_448, 115_712, 1024
#: Output columns a bf16 block may hold (the accumulator is DV / 2
#: registers a thread), largest first.
BF16_DV = (128, 64)


def head_dim_tile(d: int, elem: int = 4) -> int:
    """The head dim rounded up to a tile instantiated for elements of
    ``elem`` bytes."""
    for dp in HEAD_DIM_TILES[elem]:
        if d <= dp:
            return dp
    raise ValueError(f"flash_attention: head dim {d} above {MAX_HEAD_DIM}")


class _RowTiles:
    """Blocks of ``bm`` query rows over the s-major (s, head) rows of each
    (batch, kv head), the row tiles scheduled largest s first; ``dsplit``
    blocks per row tile, block ``z`` writing output columns
    ``[z·dv, (z+1)·dv)``."""

    @property
    def rows(self) -> int:
        """Query rows of one (batch, kv head): S × H/KVH."""
        return self.s * (self.h // self.kvh)

    @property
    def dv(self) -> int:
        return self.dp // self.dsplit

    @property
    def grid(self) -> tuple[int, int, int]:
        return (-(-self.rows // self.bm), self.b * self.kvh, self.dsplit)

    @property
    def blocks(self) -> int:
        x, y, z = self.grid
        return x * y * z

    def block_outputs(self, x: int, y: int, z: int):
        """(batch, heads, positions, column range) that block (x, y, z)
        writes: the kernel's index arithmetic, for the coverage tests."""
        group = self.h // self.kvh
        b, hk = divmod(y, self.kvh)
        r0 = (self.grid[0] - 1 - x) * self.bm
        r = np.arange(r0, min(r0 + self.bm, self.rows))
        s, j = np.divmod(r, group)
        return (b, hk * group + j, s,
                (z * self.dv, min((z + 1) * self.dv, self.d)))


@dataclasses.dataclass(frozen=True)
class LaunchPlan(_RowTiles):
    """The fp32 body's blocks: ``wr`` row groups of 16 query rows,
    ``dsplit`` blocks a row tile.  The constants mirror the source's
    ``Cfg``."""
    b: int
    s: int
    h: int
    kvh: int
    d: int
    wr: int
    dsplit: int

    @property
    def dp(self) -> int:
        return head_dim_tile(self.d)

    @property
    def wd(self) -> int:
        """Warps of a row group splitting the q·kᵀ depth and the output."""
        return self.dp // 64 if self.dp >= 128 else 1

    @property
    def bm(self) -> int:
        return 16 * self.wr

    @property
    def bkv(self) -> int:
        """Keys a kv tile."""
        return 16 if self.dp >= 128 else 32

    @property
    def threads(self) -> int:
        return 32 * self.wr * self.wd

    @property
    def smem_bytes(self) -> int:
        """The K/V ring (V's pitch padded by 4 floats), the partial-score
        exchange."""
        stage = self.bkv * ((self.dp + 8) + (self.dv + 4))
        xs = (self.wr * self.wd * (self.bkv // 8) * 32 * 4
              if self.wd > 1 else 0)
        return STAGES * stage * 4 + xs * 4

    def args(self) -> tuple[int, int]:
        """The plan's arguments of the C entry point."""
        return (self.wr, self.dsplit)


@dataclasses.dataclass(frozen=True)
class HopperPlan(_RowTiles):
    """The bf16 body's blocks: ``cw`` consumer warpgroups of 64 query rows
    and one producer warp, ``dsplit`` blocks a row tile.  The constants
    mirror the source's ``Cfg``."""
    b: int
    s: int
    h: int
    kvh: int
    d: int
    cw: int
    dsplit: int

    @property
    def dp(self) -> int:
        return head_dim_tile(self.d, 2)

    @property
    def bm(self) -> int:
        return ROWS * self.cw

    @property
    def bkv(self) -> int:
        return BKV

    @property
    def threads(self) -> int:
        """The consumers, and beside two of them a producer warpgroup (one
        consumer warpgroup loads its own tiles)."""
        return 384 if self.cw == 2 else 128

    @property
    def ring_stages(self) -> int:
        """The instance's K/V stages (``Cfg::STAGES``): as many as fit, in
        one block an SM with two consumer warpgroups, in half the SM with
        one."""
        budget = SMEM_LIMIT if self.cw == 2 else SMEM_HALF
        stage = BKV * (self.dp + self.dv) * 2
        fit = (budget - SMEM_EXTRA - self.cw * ROWS * self.dp * 2) // stage
        return min(MAX_STAGES, max(MIN_STAGES, fit))

    @property
    def stages(self) -> int:
        """The stages a launch uses: at most the longest row tile's kv
        tiles."""
        return min(self.ring_stages, (self.s - 1) // BKV + 1)

    @property
    def smem_bytes(self) -> int:
        """q tiles, the K/V ring, and the alignment slack that holds the
        barriers."""
        return (SMEM_EXTRA + self.cw * ROWS * self.dp * 2
                + self.stages * BKV * (self.dp + self.dv) * 2)

    def args(self) -> tuple[int, int]:
        """The plan's arguments of the C entry point."""
        return (self.cw, self.dsplit)


@functools.lru_cache(maxsize=1024)
def launch_plan(b: int, s: int, h: int, kvh: int, d: int,
                sms: int = 132, elem: int = 4):
    """The plan of the body for elements of ``elem`` bytes.

    fp32 (:class:`LaunchPlan`): the most query rows a block that still
    gives every SM a block, at ``MIN_WARPS`` warps a block or more.  Where
    no such block shape fills the card (short prefills): at D 256, whose
    row group alone is 4 warps, two blocks a row tile, each half of the
    output columns; below, the smallest such block.

    bf16 (:class:`HopperPlan`): two consumer warpgroups at 128 output
    columns a block where that gives every SM a block (D above 64, more
    than 64 query rows a (batch, kv head)); else one warpgroup at the
    widest columns (at most 128) that give every SM a block, or at 64
    where none does.  Timed on the H100 (PERF.md): two warpgroups
    won at the configs' S-128 shapes with D 128 and 256, one at D 64 (S 16
    to 1024, two to three blocks an SM) and at S 16."""
    if elem == 2:
        dp = head_dim_tile(d, 2)
        hplan = functools.partial(HopperPlan, b, s, h, kvh, d)
        wide = hplan(2, max(1, dp // BF16_DV[0]))
        if dp > 64 and s * (h // kvh) > ROWS and wide.blocks >= sms:
            return wide
        one = hplan(1, max(1, dp // BF16_DV[0]))
        return one if one.blocks >= sms else hplan(1, dp // BF16_DV[-1])
    plan = functools.partial(LaunchPlan, b, s, h, kvh, d)
    shapes = [wr for wr in ROW_GROUPS[head_dim_tile(d)]
              if plan(wr, 1).threads >= 32 * MIN_WARPS]
    for wr in shapes:
        if plan(wr, 1).blocks >= sms:
            return plan(wr, 1)
    return plan(1, 2) if plan(1, 1).wd >= MIN_WARPS else plan(shapes[-1], 1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, S, H, D), k and v (B, S, KVH, D) →
    o (B, S, H, D), all fp32 or all bf16 (the body of that dtype).

    Contiguous tensors of one of those dtypes on one CUDA device; another
    dtype or layout raises, as do ``H % KVH != 0``, ``D > 256`` and
    ``B·H > 65535``.  The output is allocated here; the launch is
    asynchronous on the current stream and raises if the launch is
    refused.
    """
    global launches, launches_bf16
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want "
                         "(B, S, H, D) and two (B, S, KVH, D)")
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d) or h % kvh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not pair (KVH must divide H)")
    if d > MAX_HEAD_DIM or b * h > 65535:
        raise ValueError(f"flash_attention: head dim {d} (at most "
                         f"{MAX_HEAD_DIM}) or B·H = {b * h} (at most 65535) "
                         "beyond the kernel")
    one = (q.dtype,) if q.dtype in ENTRY else tuple(ENTRY)
    cuda_build.check_operands("flash_attention", q, k, v, dtypes=(one,) * 3)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    plan = launch_plan(b, s, h, kvh, d, cuda_build.sm_count(q.device),
                       q.element_size())
    cuda_build.launch(ENTRY[q.dtype], q.device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(), b, s, h, kvh, d,
                      int(bool(causal)), *plan.args())
    if q.dtype == torch.bfloat16:
        launches_bf16 += 1
    else:
        launches += 1
    return o
