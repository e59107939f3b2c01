"""Causal (or full) softmax attention, forward: the CUDA kernel's wrapper
and its launch plan.

The kernel (``csrc/flash_attention.cu``) replaces the JAX package's Pallas
``flash_attention``: online softmax over kv tiles, fp32 accumulation, kv
tiles above the diagonal skipped under the causal mask and the final
division by ``max(l, 1e-30)``.  The TPU kernel's running max, normalizer
and accumulator lived in VMEM across its sequential kv grid axis; here
they live in registers across a kv loop inside one block.  Both products
run on the tensor cores as 3xTF32 (hi/lo splits, fp32 sums), so the
result keeps fp32 accuracy, and K/V tiles stream through a cp.async ring.
A bf16 body (q, k, v and o bf16), the same template on the element type,
computes the TPU kernel's function at bf16: the operands widened (a bf16
value is exact in TF32, so q·kᵀ takes one TF32 product and p·v two), p
kept fp32, every sum fp32, o rounded once at its store.
It reads the (B, S, H, D) layout in place, and k / v with fewer heads
(KVH dividing H; query head h reads kv head h // (H / KVH)): a block's
query rows are the (s, head) pairs of one (batch, kv head), s-major, so
grouped and multi-query attention load each K/V tile once for the group.

:func:`launch_plan` picks the rows per block and whether two blocks
share a row tile (each half of the output columns), from the shape and
the card's SM count alone, so the arithmetic that decides coverage runs
(and is tested) on the CPU.
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
#: bf16 body only at the configs' head dims (64, 128 and 256).
HEAD_DIM_TILES = {4: (32, 64, 128, 256), 2: (64, 128, 256)}
#: The dtypes the kernel takes: fp32 and bf16, one C entry point each.
ENTRY = {torch.float32: "flash_attention",
         torch.bfloat16: "flash_attention_bf16"}
#: K/V tiles in flight (``STAGES`` in the source).
STAGES = 3
#: Row groups of 16 query rows a block may hold, largest first, by head-dim
#: tile (8 warps at most: D 256 splits q·kᵀ over 4 warps a row group).
ROW_GROUPS = {32: (4, 2, 1), 64: (4, 2, 1), 128: (4, 2, 1), 256: (2, 1)}
#: Fewest warps a block holds (its warps share each K/V tile): at a short
#: prefill, fewer blocks of 4 warps ran faster than more blocks of one.
MIN_WARPS = 4


def head_dim_tile(d: int, elem: int = 4) -> int:
    """The head dim rounded up to a tile instantiated for elements of
    ``elem`` bytes."""
    for dp in HEAD_DIM_TILES[elem]:
        if d <= dp:
            return dp
    raise ValueError(f"flash_attention: head dim {d} above {MAX_HEAD_DIM}")


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Blocks of ``wr`` row groups of 16 query rows over the s-major (s,
    head) rows of each (batch, kv head); ``dsplit`` blocks per row tile,
    block ``z`` computing output columns ``[z·dv, (z+1)·dv)``; ``elem``
    the bytes of an element (4 for the fp32 body, 2 for bf16).  The
    constants mirror the source's ``Cfg``."""
    b: int
    s: int
    h: int
    kvh: int
    d: int
    wr: int
    dsplit: int
    elem: int = 4

    @property
    def dp(self) -> int:
        return head_dim_tile(self.d, self.elem)

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
    def dv(self) -> int:
        return self.dp // self.dsplit

    @property
    def threads(self) -> int:
        return 32 * self.wr * self.wd

    @property
    def rows(self) -> int:
        """Query rows of one (batch, kv head): S × H/KVH."""
        return self.s * (self.h // self.kvh)

    @property
    def grid(self) -> tuple[int, int, int]:
        return (-(-self.rows // self.bm), self.b * self.kvh, self.dsplit)

    @property
    def blocks(self) -> int:
        x, y, z = self.grid
        return x * y * z

    @property
    def smem_bytes(self) -> int:
        """The K/V ring in elements (V's pitch padded by 16 bytes), the
        partial-score exchange in fp32."""
        stage = self.bkv * ((self.dp + 8) + (self.dv + 16 // self.elem))
        xs = (self.wr * self.wd * (self.bkv // 8) * 32 * 4
              if self.wd > 1 else 0)
        return STAGES * stage * self.elem + xs * 4

    def args(self) -> tuple[int, int]:
        """The plan's arguments of the C entry point."""
        return (self.wr, self.dsplit)

    def block_outputs(self, x: int, y: int, z: int):
        """(batch, heads, positions, column range) that block (x, y, z)
        writes: the kernel's index arithmetic (row tiles scheduled in
        reverse), for the coverage tests."""
        group = self.h // self.kvh
        b, hk = divmod(y, self.kvh)
        r0 = (self.grid[0] - 1 - x) * self.bm
        r = np.arange(r0, min(r0 + self.bm, self.rows))
        s, j = np.divmod(r, group)
        return (b, hk * group + j, s,
                (z * self.dv, min((z + 1) * self.dv, self.d)))


@functools.lru_cache(maxsize=1024)
def launch_plan(b: int, s: int, h: int, kvh: int, d: int,
                sms: int = 132, elem: int = 4) -> LaunchPlan:
    """The most query rows a block that still gives every SM a block, at
    ``MIN_WARPS`` warps a block or more.  Where no such block shape fills
    the card (short prefills): at D 256, whose row group alone is 4 warps,
    two blocks a row tile, each half of the output columns; below, the
    smallest such block."""
    plan = functools.partial(LaunchPlan, b, s, h, kvh, d, elem=elem)
    shapes = [wr for wr in ROW_GROUPS[head_dim_tile(d, elem)]
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
