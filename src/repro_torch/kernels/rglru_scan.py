"""RG-LRU linear recurrence ``h_t = a_t ⊙ h_{t-1} + b_t`` (h₋₁ = 0) and its
gradient: the CUDA kernels' wrappers and their launch plan.

The forward kernel (``csrc/rglru_scan.cu``) replaces the JAX package's
Pallas ``rglru_scan``; the backward kernel is the gradient the JAX package
takes through XLA (the transpose of its scan), one reverse chain a channel:
``d_t = g_t + a_{t+1} d_{t+1}``, ``db_t = d_t``, ``da_t = d_t h_{t-1}``.
Both run one thread a (batch, channel) chain, each step a rounded product
and then a rounded sum, as the plain versions do, so the forward is
bitwise :func:`~repro_torch.kernels.ref.rglru_scan_ref` and the backward
bitwise its autograd (:func:`~repro_torch.kernels.ref.rglru_scan_bwd_ref`).
A block of ``ct`` threads owns ``ct`` channels of one batch and stages the
sequence in shared memory (cp.async copies, issued ahead of the chains):
one chunk of the whole sequence where S ≤ ``CHUNK``, else a ring of
``stages`` chunks of ``CHUNK`` time steps.

:func:`launch_plan` picks ``ct``, ``tc`` and the stages from the shape
alone, and runs (and is tested) on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from . import cuda_build

#: Kernel launches made by :func:`rglru_scan` (the forward) and by
#: :func:`rglru_scan_bwd` in this process.
launches = 0
launches_bwd = 0

#: Channels (threads) a block may own, largest first (the source's
#: instances).
CHANNEL_TILES = (64, 32)
#: Time steps a chunk holds (the source's ``CHUNK``): a sequence of at most
#: this many is one chunk (the short body), a longer one chunks of this
#: many in a ring (the ring body).
CHUNK = 32
#: Chunks the ring holds at most: the forward stages a and b, the backward
#: a, g and h, so three of its stages take as much shared memory as 4.5 of
#: the forward's (and three blocks of either fit an SM).
STAGES = {"forward": 4, "backward": 3}
OPERANDS = {"forward": 2, "backward": 3}
#: Dynamic shared memory a block may take on the H100 (227 KB).
SMEM_MAX = 232448


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Block ``(x, y)`` owns channels ``[x·ct, (x+1)·ct)`` of batch ``y``,
    thread ``j`` the chain of channel ``x·ct + j``; chunk ``k`` of its ring
    holds the rows of :meth:`chunk_steps`."""
    b: int
    s: int
    c: int
    direction: str          # "forward" or "backward"
    ct: int
    tc: int
    stages: int
    vec: int                # floats a cp.async copy: 4 (16 bytes) or 1

    @property
    def blocks(self) -> int:
        return self.b * -(-self.c // self.ct)

    @property
    def chunks(self) -> int:
        return -(-self.s // self.tc)

    @property
    def body(self) -> str:
        """``"short"`` (one chunk, static shared memory) or ``"ring"``."""
        return "short" if self.stages == 1 else "ring"

    @property
    def smem(self) -> int:
        """Shared memory of a block, in bytes (the short body's static tile
        holds ``CHUNK`` rows)."""
        rows = CHUNK if self.body == "short" else self.tc
        return self.stages * OPERANDS[self.direction] * rows * self.ct * 4

    def args(self) -> tuple[int, int, int, int]:
        """The plan's arguments of the C entry points."""
        return (self.ct, self.tc, self.stages, self.vec)

    def block_channels(self, x: int) -> range:
        """The channels whose chains block column ``x`` runs."""
        return range(x * self.ct, min((x + 1) * self.ct, self.c))

    def chunk_steps(self, k: int) -> range:
        """The time steps of chunk ``k``, in the order the chains take them
        (the forward upwards from 0, the backward downwards from S - 1)."""
        if self.direction == "forward":
            return range(k * self.tc, min((k + 1) * self.tc, self.s))
        t1 = self.s - k * self.tc
        return range(t1 - 1, max(t1 - self.tc, 0) - 1, -1)


@functools.lru_cache(maxsize=1024)
def launch_plan(b: int, s: int, c: int, direction: str = "forward",
                aligned: bool = True, sms: int = 132) -> LaunchPlan:
    """The widest channel tile that still gives every SM two blocks (the
    narrowest where none does); the whole sequence as one chunk at
    S ≤ ``CHUNK`` (the short body), else chunks of ``CHUNK`` steps in a
    ring of up to ``STAGES[direction]`` (as many as the sequence has, if
    fewer); 16-byte copies where C % 4 == 0 and the operands are
    ``aligned`` to 16 bytes."""
    if direction not in STAGES:
        raise ValueError(f"rglru_scan: direction {direction!r}")
    ct = next((t for t in CHANNEL_TILES if b * -(-c // t) >= 2 * sms),
              CHANNEL_TILES[-1])
    tc = min(CHUNK, s)
    stages = 1 if s <= CHUNK else min(STAGES[direction], -(-s // CHUNK))
    vec = 4 if aligned and c % 4 == 0 else 1
    return LaunchPlan(b, s, c, direction, ct, tc, stages, vec)


def _check(name: str, *tensors: torch.Tensor) -> tuple[int, int, int]:
    shape = tensors[0].shape
    if tensors[0].ndim != 3 or any(t.shape != shape for t in tensors):
        raise ValueError(f"{name}: {[tuple(t.shape) for t in tensors]}: "
                         "want (B, S, C) each")
    cuda_build.check_operands(name, *tensors)
    if shape[0] > 65535:
        raise ValueError(f"{name}: B = {shape[0]} exceeds the kernel's grid "
                         "(65535)")
    return tuple(shape)


def _plan(x: torch.Tensor, direction: str, *inputs) -> LaunchPlan:
    bsz, s, c = x.shape
    return launch_plan(bsz, s, c, direction,
                       all(t.data_ptr() % 16 == 0 for t in inputs),
                       cuda_build.sm_count(x.device))


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel: a, b (B, S, C) fp32 → h (B, S, C) fp32.

    Contiguous fp32 tensors on one CUDA device; another dtype or layout
    raises.  The output is allocated here; the launch is asynchronous on
    the current stream and raises if the launch is refused.
    """
    global launches
    bsz, s, c = _check("rglru_scan", a, b)
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    plan = _plan(a, "forward", a, b)
    cuda_build.launch("rglru_scan", a.device, a.data_ptr(), b.data_ptr(),
                      h.data_ptr(), bsz, s, c, *plan.args())
    launches += 1
    return h


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: a, the forward's output h and its
    gradient g, each (B, S, C) fp32 → (da, db), the gradients of a and b.

    Contiguous fp32 tensors on one CUDA device, as for :func:`rglru_scan`.
    """
    global launches_bwd
    bsz, s, c = _check("rglru_scan_bwd", a, h, g)
    da, db = torch.empty_like(a), torch.empty_like(a)
    if da.numel() == 0:
        return da, db
    plan = _plan(a, "backward", a, h, g)
    cuda_build.launch("rglru_scan_bwd", a.device, a.data_ptr(), h.data_ptr(),
                      g.data_ptr(), da.data_ptr(), db.data_ptr(), bsz, s, c,
                      *plan.args())
    launches_bwd += 1
    return da, db
