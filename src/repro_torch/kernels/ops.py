"""Public op wrappers for the merged-segment conv kernels.

Each ``*_op`` takes the JAX package's layouts (NHWC activations, HWIO
weights) and dispatches on where its input lies:

* a CPU tensor runs the op's plain PyTorch version (:mod:`.ref`) — this is
  how the CPU tests hold the port against the JAX package;
* a CUDA tensor launches the hand-written kernel, or raises.  There is no
  fallback: a kernel that fails to build or launch is an error.

The quantized paths (``w_scale`` / ``act_quant``) have plain versions
(``*_qref``) but no CUDA kernel yet; on a CUDA tensor they raise
``NotImplementedError`` naming the ROADMAP row that ports them.

Launch counts: each kernel wrapper adds one to its module's ``launches``
per launch; :func:`launch_counts` reads them and
:func:`reset_launch_counts` sets them to zero, so a run can show that its
path went through the kernels.
"""
from __future__ import annotations

import torch

from . import depthwise_conv as _dw
from . import merged_conv as _mc
from . import ref

_QUANT_ROW = ("the quantized {name} kernel (int8 / w8a8 / fp8 weights with "
              "w_scale) is not ported yet: ROADMAP.md queue 2, 'quantized "
              "{name}'")


def _on_cuda(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"{name}: no kernel for device {x.device}")


def channel_tile(cout: int, requested: int | None) -> int:
    """Channel tile used by the grouped tile planner: a multiple of 8, at
    most 128; explicit requests round up into [8, 128]."""
    if requested is not None:
        return max(8, min(-(-requested // 8) * 8, 128))
    if cout >= 128:
        return 128
    return -(-max(cout, 8) // 8) * 8


def merged_conv_op(x, w, b=None, *, stride: int = 1,
                   activation: str | None = None, w_scale=None,
                   act_quant: str = "none"):
    """Merged-segment conv (VALID, stride ``s``) with fused bias + boundary
    activation.  ``w_scale`` (per-output-channel) marks ``w`` as narrow;
    ``act_quant="w8a8"`` also quantizes the activation per tensor."""
    if not _on_cuda(x, "merged_conv_op"):
        if w_scale is not None:
            y = ref.merged_conv_qref(x, w, b, w_scale, stride=stride,
                                     act_quant=act_quant)
        else:
            y = ref.merged_conv_ref(x, w, b, stride=stride)
        return ref.apply_activation(y, activation)
    if w_scale is not None:
        raise NotImplementedError(_QUANT_ROW.format(name="merged_conv"))
    return _mc.merged_conv(x.contiguous(), w.contiguous(),
                           None if b is None else b.contiguous(),
                           stride=stride, activation=activation)


def depthwise_conv_op(x, w, b=None, *, stride: int = 1,
                      groups: int | None = None,
                      activation: str | None = None, w_scale=None,
                      act_quant: str = "none"):
    """Grouped/depthwise merged-segment conv (VALID, stride ``s``) with
    fused bias + boundary activation.  ``groups`` defaults to the
    depthwise reading ``Cin // Cin_g`` of the HWIO weight."""
    if groups is None:
        groups = x.shape[-1] // w.shape[2]
    if not _on_cuda(x, "depthwise_conv_op"):
        if w_scale is not None:
            y = ref.depthwise_conv_qref(x, w, b, w_scale, stride=stride,
                                        groups=groups, act_quant=act_quant)
        else:
            y = ref.depthwise_conv_ref(x, w, b, stride=stride, groups=groups)
        return ref.apply_activation(y, activation)
    if w_scale is not None:
        raise NotImplementedError(_QUANT_ROW.format(name="depthwise_conv"))
    return _dw.depthwise_conv(x.contiguous(), w.contiguous(),
                              None if b is None else b.contiguous(),
                              stride=stride, groups=groups,
                              activation=activation)


def launch_counts() -> dict[str, int]:
    """Kernel launches in this process since the last reset."""
    return {"merged_conv": _mc.launches, "depthwise_conv": _dw.launches}


def reset_launch_counts() -> None:
    _mc.launches = 0
    _dw.launches = 0
