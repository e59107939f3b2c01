"""Device resolution shared by every entry point of the port.

Entry points default to ``device="cuda"`` and raise where there is no
card: only a caller who passes ``device="cpu"`` gets the CPU (the plain
PyTorch versions of the kernels).  Resolving a CUDA device also turns
TF32 off for cuDNN convolutions and cuBLAS matmuls — process-wide — so
weight merging (``F.conv2d`` in :mod:`repro_torch.core.merge`), the
replaced network and the plain kernel versions compute in full fp32 on
the card, as they do on the CPU.
"""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no
    CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def device_name(dev: torch.device) -> str:
    """The card's name for a CUDA device, ``"cpu"`` otherwise."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type
