"""RG-LRU linear recurrence ``h_t = a_t ⊙ h_{t-1} + b_t`` (h₀ = 0): the
CUDA kernel's wrapper.

The kernel (``csrc/rglru_scan.cu``) replaces the JAX package's Pallas
``rglru_scan``: the TPU kernel carried h in VMEM across its sequential
time tiles; here one thread owns one (batch, channel) and loops over the
whole sequence with h in a register, consecutive threads on consecutive
channels.  Each step rounds the product and then the sum, as the plain
version does, so the two agree bitwise.
"""
from __future__ import annotations

import torch

from . import cuda_build

#: Kernel launches made by :func:`rglru_scan` in this process.
launches = 0


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: a, b (B, S, C) fp32 → h (B, S, C) fp32.

    Contiguous fp32 tensors on one CUDA device; another dtype or layout
    raises.  The output is allocated here; the launch is asynchronous on
    the current stream and raises if the launch is refused.
    """
    global launches
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}: want two (B, S, C)")
    cuda_build.check_operands("rglru_scan", a, b)
    bsz, s, c = a.shape
    if bsz > 65535:
        raise ValueError(f"rglru_scan: B = {bsz} exceeds the kernel's grid "
                         "(65535)")
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    cuda_build.launch("rglru_scan", a.device, a.data_ptr(), b.data_ptr(),
                      h.data_ptr(), bsz, s, c)
    launches += 1
    return h
