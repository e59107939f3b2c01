"""Row-wise RMSNorm ``y = x · rsqrt(mean x² + eps) · (1 + g)``: the CUDA
kernel's wrapper.

The kernel (``csrc/rmsnorm.cu``) replaces the JAX package's Pallas
``rmsnorm``: one block per row, the sum of squares reduced in fp32 by warp
shuffles and shared memory, then a second pass over the row (still in
cache) writes the output.  fp32 in and out; the port's transformer host
runs fp32 only.
"""
from __future__ import annotations

import torch

from . import cuda_build

#: Kernel launches made by :func:`rmsnorm` in this process.
launches = 0


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """Launch the CUDA kernel: x (M, D), g (D,) → y (M, D), fp32.

    Contiguous fp32 tensors on one CUDA device; another dtype or layout
    raises.  The output is allocated here; the launch is asynchronous on
    the current stream and raises if the launch is refused.
    """
    global launches
    if x.ndim != 2 or g.ndim != 1 or g.shape[0] != x.shape[1]:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)}, g {tuple(g.shape)}: "
                         "want (M, D) and (D,)")
    cuda_build.check_operands("rmsnorm", x, g)
    m, d = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    vec = d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, g, y))
    cuda_build.launch("rmsnorm", x.device, x.data_ptr(), g.data_ptr(),
                      y.data_ptr(), m, d, float(eps), int(vec))
    launches += 1
    return y
