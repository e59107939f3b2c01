"""Merged rank-r residual layer ``y = x + (x @ U) @ V``: the CUDA kernel's
wrapper.

The kernel (``csrc/merged_ffn.cu``) replaces the JAX package's Pallas
``merged_ffn``: both products and the residual add in one launch, fp32
accumulation, ``P = x @ U`` kept in shared memory.  The TPU kernel carried
the P panel across its sequential j sweeps; here the blocks of one m-panel
form a thread-block cluster and share their chunks of P through
distributed shared memory (see the source's header for the cost and the
bound).
"""
from __future__ import annotations

import torch

from . import cuda_build

#: Kernel launches made by :func:`merged_ffn` in this process.
launches = 0

#: Rows per block (``BM`` in the source): the grid's y extent is M / 32.
_ROWS_PER_BLOCK = 32


def merged_ffn(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """Launch the CUDA kernel: x (M, D), u (D, R), v (R, D) → (M, D).

    fp32, contiguous tensors on one CUDA device.  The output is allocated
    here; the launch is asynchronous on the current stream and raises if
    the launch is refused.
    """
    global launches
    if x.ndim != 2 or u.ndim != 2 or v.ndim != 2:
        raise ValueError(f"merged_ffn: x {tuple(x.shape)}, u "
                         f"{tuple(u.shape)}, v {tuple(v.shape)} must be 2-D")
    m, d = x.shape
    r = u.shape[1]
    if u.shape[0] != d or tuple(v.shape) != (r, d):
        raise ValueError(f"merged_ffn: x {tuple(x.shape)}, u "
                         f"{tuple(u.shape)}, v {tuple(v.shape)}")
    cuda_build.check_operands("merged_ffn", x, u, v)
    if -(-m // _ROWS_PER_BLOCK) > 65535:
        raise ValueError(f"merged_ffn: M = {m} rows exceed the kernel's "
                         f"grid (65535 tiles of {_ROWS_PER_BLOCK})")
    y = torch.empty((m, d), device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    cuda_build.launch("merged_ffn", x.device, x.data_ptr(), u.data_ptr(),
                      v.data_ptr(), y.data_ptr(), m, d, r)
    launches += 1
    return y
