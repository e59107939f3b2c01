"""Causal (or full) softmax attention, forward: the CUDA kernel's wrapper.

The kernel (``csrc/flash_attention.cu``) replaces the JAX package's Pallas
``flash_attention``: online softmax over kv tiles, fp32 accumulation, kv
tiles above the diagonal skipped under the causal mask and the final
division by ``max(l, 1e-30)``.  The TPU kernel's running max, normalizer
and accumulator lived in VMEM across its sequential kv grid axis; here
they live in registers across a kv loop inside one block per (batch·head,
32-row q tile).  It reads the (B, S, H, D) layout in place, and k / v with
fewer heads (KVH dividing H; query head h reads kv head h // (H / KVH)),
so grouped and multi-query attention read their kv heads once instead of
expanding them.
"""
from __future__ import annotations

import torch

from . import cuda_build

#: Kernel launches made by :func:`flash_attention` in this process.
launches = 0

#: Largest head dim the kernel takes (its register tile is D / 32 columns
#: per lane, instantiated for 32, 64, 128 and 256).
MAX_HEAD_DIM = 256


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, S, H, D), k and v (B, S, KVH, D) →
    o (B, S, H, D), all fp32.

    Contiguous fp32 tensors on one CUDA device; another dtype or layout
    raises, as do ``H % KVH != 0``, ``D > 256`` and ``B·H > 65535``.  The
    output is allocated here; the launch is asynchronous on the current
    stream and raises if the launch is refused.
    """
    global launches
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
    cuda_build.check_operands("flash_attention", q, k, v)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    cuda_build.launch("flash_attention", q.device, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h, kvh,
                      d, int(bool(causal)))
    launches += 1
    return o
