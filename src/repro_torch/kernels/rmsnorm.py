"""Row-wise RMSNorm ``y = x · rsqrt(mean x² + eps) · (1 + g)``: the CUDA
kernel's wrapper and its launch plan.

The kernel (``csrc/rmsnorm.cu``) replaces the JAX package's Pallas
``rmsnorm``.  Where D % 4 == 0, the rows are aligned and D ≤ 640, a warp
owns a row: each lane loads its four-element chunks (a float4, or four
bf16 in 8 bytes) and g's once, keeps them in registers, sums their squares
in fp32 and the warp adds the lanes' sums by shuffles, then writes the
row; several rows a block, as many as still fill the card.  Wider rows
take a block a row (the same chunks, a shared-memory reduction, a second
pass over the row), ragged or unaligned ones the same block element by
element.  Two bodies of one template: fp32 (x, g, y fp32), and bf16 (x, y
bf16; g bf16 or fp32), which widens its loads, runs the fp32 body's
arithmetic in the same order and rounds once, at the store — the TPU
kernel's function at bf16 (fp32 inside, ``x.dtype`` out).

:func:`launch_plan` picks the path and the rows a block from D, the
alignment and M alone, the same for both bodies (so the bf16 body's output
is bitwise the fp32 body's on the widened operands, rounded), and runs
(and is tested) on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from . import cuda_build

#: Kernel launches made by :func:`rmsnorm` in this process: the fp32 body
#: and the bf16 body.
launches = 0
launches_bf16 = 0

#: The dtypes of x the kernel takes, and of g beside each.
G_DTYPES = {torch.float32: (torch.float32,),
            torch.bfloat16: (torch.bfloat16, torch.float32)}

#: The paths of the source's ``launch``: a block a row element by element,
#: a block a row four elements a load, a warp a row.
PATHS = {"scalar": 0, "block": 1, "warp": 2}
#: Threads of a block-a-row block (``THREADS`` in the source), the most a
#: warp-path block holds too.
THREADS = 256
#: Elements of a chunk (one load), and the chunks a lane of the warp path
#: may hold (the instances of ``rmsnorm_warp``): D up to 640.
CHUNK = 4
WARP_CHUNKS = (1, 2, 3, 4, 5)
WARP_MAX_D = 32 * CHUNK * WARP_CHUNKS[-1]
#: Rows a warp-path block may hold, largest first.
WARP_ROWS = (8, 4, 2, 1)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Row ``r`` of x (M, D) to block ``r // wr``: on the warp path, warp
    ``r % wr`` of it, whose lane ``l`` holds the chunks of ``CHUNK``
    elements ``l + 32 j``, ``j < nq``; on the block paths (``wr`` 1) the
    block's ``THREADS`` threads."""
    m: int
    d: int
    path: str
    wr: int = 1
    nq: int = 0

    @property
    def threads(self) -> int:
        return 32 * self.wr if self.path == "warp" else THREADS

    @property
    def blocks(self) -> int:
        return -(-self.m // self.wr)

    def args(self) -> tuple[int, int, int]:
        """The plan's arguments of the C entry points."""
        return (PATHS[self.path], self.wr, self.nq)

    def block_rows(self, x: int) -> range:
        """The rows that block ``x`` writes."""
        return range(x * self.wr, min((x + 1) * self.wr, self.m))

    def lane_chunks(self, lane: int) -> list[int]:
        """The chunks of a row that a lane of the warp path loads, scales
        and stores, in its order of summation."""
        return [c for c in (lane + 32 * j for j in range(self.nq))
                if c < self.d // CHUNK]


@functools.lru_cache(maxsize=1024)
def launch_plan(m: int, d: int, aligned: bool = True,
                sms: int = 132) -> LaunchPlan:
    """Where ``aligned`` (x, g and y aligned to four of their elements)
    and D % 4 == 0: the warp path up to ``WARP_MAX_D``, with the fewest
    chunks a lane that hold the row and the most rows a block that still
    give every SM a block (one row a block where M cannot fill the card: a
    decode step), and a block a row, four elements a load, above it; else
    a block a row, element by element."""
    if not (aligned and d % CHUNK == 0):
        return LaunchPlan(m, d, "scalar")
    if d > WARP_MAX_D:
        return LaunchPlan(m, d, "block")
    nq = next(n for n in WARP_CHUNKS if 32 * CHUNK * n >= d)
    wr = next((w for w in WARP_ROWS if -(-m // w) >= sms), 1)
    return LaunchPlan(m, d, "warp", wr, nq)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """Launch the CUDA kernel: x (M, D), g (D,) → y (M, D) of x's dtype.

    Contiguous tensors on one CUDA device: x fp32 with g fp32, or x bf16
    with g bf16 or fp32; another dtype or layout raises.  The output is
    allocated here; the launch is asynchronous on the current stream and
    raises if the launch is refused.
    """
    global launches, launches_bf16
    if x.ndim != 2 or g.ndim != 1 or g.shape[0] != x.shape[1]:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)}, g {tuple(g.shape)}: "
                         "want (M, D) and (D,)")
    cuda_build.check_operands("rmsnorm", x, g, dtypes=(
        tuple(G_DTYPES), G_DTYPES.get(x.dtype, ())))
    m, d = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    # loads of four elements: 16 bytes of fp32, 8 of bf16
    plan = launch_plan(m, d, all(t.data_ptr() % (CHUNK * t.element_size())
                                 == 0 for t in (x, g, y)),
                       cuda_build.sm_count(x.device))
    if x.dtype == torch.bfloat16:
        cuda_build.launch("rmsnorm_bf16", x.device, x.data_ptr(),
                          g.data_ptr(), y.data_ptr(), m, d, float(eps),
                          int(g.dtype == torch.float32), *plan.args())
        launches_bf16 += 1
    else:
        cuda_build.launch("rmsnorm", x.device, x.data_ptr(), g.data_ptr(),
                          y.data_ptr(), m, d, float(eps), *plan.args())
        launches += 1
    return y
