"""Layer merging — the paper's ``θ_j * … * θ_i`` composition, in PyTorch.

Conventions follow the JAX package: conv weights are ``(kh, kw, cin,
cout)`` (HWIO) acting by cross-correlation with VALID padding inside a
merged group; depthwise convs are ``(kh, kw, 1, c)`` with
``groups = c``.

* ``merge_conv_pair``  — Eq. 1: two stride-``s`` correlations compose into
  one with kernel ``(k2−1)·s1 + k1`` and stride ``s1·s2``; the merged
  weight is the convolution of the kernels over space with the middle
  channel contracted and the second kernel dilated by ``s1``.
* ``identity_kernel``  — the paper's ``θ_id``: 1×1 depthwise ones.
* ``fuse_skip_add``    — ``x + conv(x)`` as one conv with a centred Dirac
  added (shape-preserving, odd kernel, stride 1).
* ``fold_batchnorm``   — inference-time BN folding.

The general case runs ``F.conv2d``; on a CUDA device that is cuDNN, so
callers resolve the device through :func:`repro_torch.device.resolve`,
which turns TF32 off — otherwise the merged weights would be rounded.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def identity_kernel(c: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """θ_id — 1×1 depthwise conv of ones ((1, 1, 1, c) HWIO grouped)."""
    return torch.ones((1, 1, 1, c), dtype=dtype, device=device)


def _dw_to_full(w: torch.Tensor) -> torch.Tensor:
    """Expand a depthwise kernel (kh, kw, 1, c) to a full (kh, kw, c, c)."""
    c = w.shape[-1]
    eye = torch.eye(c, dtype=w.dtype, device=w.device)
    return w[:, :, 0, :][:, :, None, :] * eye[None, None]


def merge_conv_pair(w1: torch.Tensor, w2: torch.Tensor, *, stride1: int = 1,
                    dw1: bool = False, dw2: bool = False
                    ) -> tuple[torch.Tensor, bool]:
    """Merged kernel for ``conv2 ∘ conv1`` (correlation, VALID, HWIO).

    Returns ``(w_merged, merged_is_depthwise)``; only depthwise∘depthwise
    stays depthwise.
    """
    both_dw = dw1 and dw2
    if dw1 and not both_dw:
        w1, dw1 = _dw_to_full(w1), False
    if dw2 and not both_dw:
        w2, dw2 = _dw_to_full(w2), False

    if both_dw:
        c = w1.shape[-1]
        k1h, k1w = w1.shape[0], w1.shape[1]
        k2h, k2w = w2.shape[0], w2.shape[1]
        mh = (k2h - 1) * stride1 + k1h
        mw = (k2w - 1) * stride1 + k1w
        out = torch.zeros((mh, mw, 1, c), dtype=w1.dtype, device=w1.device)
        for u in range(k2h):
            for v in range(k2w):
                out[u * stride1:u * stride1 + k1h,
                    v * stride1:v * stride1 + k1w] += \
                    w1 * w2[u, v, 0, :][None, None, None, :]
        return out, True

    # wm[s', c, o] = Σ_m Σ_{v·s + u = s'} w2[v, m, o] · w1[u, c, m]: a
    # correlation of w1 (batch = cin, channels = mid) with the flipped,
    # s-dilated w2, zero-padded so every partial overlap is kept.
    k1h, k1w, cin, mid = w1.shape
    k2h, k2w, mid2, cout = w2.shape
    if mid != mid2:
        raise ValueError(f"merge_conv_pair: {tuple(w1.shape)} then "
                         f"{tuple(w2.shape)}")
    lhs = w1.permute(2, 3, 0, 1)                         # (cin, mid, k1h, k1w)
    rhs = torch.flip(w2, dims=(0, 1)).permute(3, 2, 0, 1)   # (cout, mid, ..)
    out = F.conv2d(lhs, rhs, padding=((k2h - 1) * stride1,
                                      (k2w - 1) * stride1),
                   dilation=stride1)                     # (cin, cout, mh, mw)
    return out.permute(2, 3, 0, 1).contiguous(), False


def merge_conv_chain(weights, strides, depthwise_flags):
    """Fold a whole chain ``f_n ∘ … ∘ f_1`` into one kernel: returns
    ``(w_merged, total_stride, merged_is_depthwise)``."""
    w, dw = weights[0], depthwise_flags[0]
    s_acc = strides[0]
    for wn, sn, dn in zip(weights[1:], strides[1:], depthwise_flags[1:]):
        w, dw = merge_conv_pair(w, wn, stride1=s_acc, dw1=dw, dw2=dn)
        s_acc *= sn
    return w, s_acc, dw


def merge_bias_through(w2: torch.Tensor, b1: torch.Tensor,
                       b2: torch.Tensor | None, dw2: bool = False
                       ) -> torch.Tensor:
    """Bias of ``conv2 ∘ (conv1 + b1)``: ``b2 + Σ_spatial w2 · b1``."""
    if dw2:
        contrib = w2.sum(dim=(0, 1))[0] * b1
    else:
        contrib = torch.einsum("hwio,i->o", w2, b1)
    return contrib if b2 is None else b2 + contrib


def fuse_skip_add(w: torch.Tensor, depthwise: bool = False) -> torch.Tensor:
    """Fold ``x + conv(x)`` into one conv by adding a centred Dirac kernel
    (odd kernel, stride 1, cin == cout)."""
    kh, kw = w.shape[0], w.shape[1]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError("Dirac fusion needs odd kernels")
    w = w.clone()
    if depthwise:
        w[kh // 2, kw // 2, 0, :] += 1.0
        return w
    if w.shape[2] != w.shape[3]:
        raise ValueError("skip-add fusion needs cin == cout")
    w[kh // 2, kw // 2] += torch.eye(w.shape[2], dtype=w.dtype,
                                     device=w.device)
    return w


def fold_batchnorm(w: torch.Tensor, b: torch.Tensor | None, gamma, beta,
                   mean, var, eps: float = 1e-5
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inference-time BN folding: ``BN(conv(x))`` → one conv."""
    scale = gamma / torch.sqrt(var + eps)
    w_f = w * scale[None, None, None, :]
    b0 = torch.zeros_like(mean) if b is None else b
    return w_f, beta + (b0 - mean) * scale
