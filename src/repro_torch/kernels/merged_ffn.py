"""Merged rank-r residual layer ``y = x + (x @ U) @ V``: the CUDA kernel's
wrapper.

The kernel (``csrc/merged_ffn.cu``) replaces the JAX package's Pallas
``merged_ffn``: both products and the residual add in one launch, fp32
accumulation, ``P = x @ U`` kept in shared memory.  The TPU kernel carried
the P panel across its sequential j sweeps; here the blocks of one m-panel
form a thread-block cluster and share their chunks of P through
distributed shared memory (see the source's header for the cost and the
bound).  Its quantized variant (``u_scale``/``v_scale``) takes int8 or
fp8-e4m3 ``U``/``V`` and builds ``P`` from an int8 panel ``xq`` (w8a8) or
from ``x``; the residual is always the fp32 ``x``.
"""
from __future__ import annotations

import torch

from . import cuda_build

#: Kernel launches made by :func:`merged_ffn` in this process: fp32, and
#: the quantized variant.
launches = 0
launches_q = 0

#: Rows per block (``BM`` in the source): the grid's y extent is M / 32.
_ROWS_PER_BLOCK = 32


def merged_ffn(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
               u_scale: torch.Tensor | None = None,
               v_scale: torch.Tensor | None = None,
               xq: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: x (M, D), u (D, R), v (R, D) → (M, D).

    Contiguous tensors on one CUDA device.  Without scales every operand
    is fp32.  With ``u_scale`` (R,) and ``v_scale`` (D,) fp32 the
    quantized variant runs: ``u``/``v`` int8 or float8_e4m3fn, ``P`` built
    from ``xq`` (M, D) int8 (w8a8; its scale folded into ``u_scale``) or
    from ``x`` when ``xq`` is None, ``y = x + ((xq @ u)·u_scale) @ v ·
    v_scale``.  The output (fp32) is allocated here; the launch is
    asynchronous on the current stream and raises if the launch is
    refused.
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
    if -(-m // _ROWS_PER_BLOCK) > 65535:
        raise ValueError(f"merged_ffn: M = {m} rows exceed the kernel's "
                         f"grid (65535 tiles of {_ROWS_PER_BLOCK})")
    y = torch.empty((m, d), device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    if not quant:
        cuda_build.launch("merged_ffn", x.device, x.data_ptr(), u.data_ptr(),
                          v.data_ptr(), y.data_ptr(), m, d, r)
        launches += 1
        return y
    panel = x if xq is None else xq
    cuda_build.launch("merged_ffn_q", x.device, x.data_ptr(),
                      panel.data_ptr(), u.data_ptr(), v.data_ptr(),
                      u_scale.data_ptr(), v_scale.data_ptr(), y.data_ptr(),
                      m, d, r, cuda_build.X_TYPES[panel.dtype],
                      cuda_build.W_TYPES[u.dtype])
    launches_q += 1
    return y
