"""Row-wise RMSNorm ``y = x · rsqrt(mean x² + eps) · (1 + g)``: the CUDA
kernel's wrapper.

The kernel (``csrc/rmsnorm.cu``) replaces the JAX package's Pallas
``rmsnorm``: one block per row, the sum of squares reduced in fp32 by warp
shuffles and shared memory, then a second pass over the row (still in
cache) writes the output.  Two bodies of one template: fp32 (x, g, y
fp32), and bf16 (x, y bf16; g bf16 or fp32), which widens its loads,
runs the fp32 body's arithmetic in the same order and rounds once, at the
store — the TPU kernel's function at bf16 (fp32 inside, ``x.dtype`` out).
"""
from __future__ import annotations

import torch

from . import cuda_build

#: Kernel launches made by :func:`rmsnorm` in this process: the fp32 body
#: and the bf16 body.
launches = 0
launches_bf16 = 0

#: The dtypes of x the kernel takes, and of g beside each.
G_DTYPES = {torch.float32: (torch.float32,),
            torch.bfloat16: (torch.bfloat16, torch.float32)}


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
    # four elements a load: 16 bytes of fp32, 8 of bf16
    vec = d % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0
                             for t in (x, g, y))
    if x.dtype == torch.bfloat16:
        cuda_build.launch("rmsnorm_bf16", x.device, x.data_ptr(),
                          g.data_ptr(), y.data_ptr(), m, d, float(eps),
                          int(g.dtype == torch.float32), int(vec))
        launches_bf16 += 1
    else:
        cuda_build.launch("rmsnorm", x.device, x.data_ptr(), g.data_ptr(),
                          y.data_ptr(), m, d, float(eps), int(vec))
        launches += 1
    return y
