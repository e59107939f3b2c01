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

import contextlib
import threading

import torch

_DRAW = threading.local()


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


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms (and no autotuning)
    inside the block, the previous settings restored after; every other
    setting (TF32 included) is left as it is.  cuDNN's default
    weight-gradient algorithms sum with atomics, so two runs of one
    fine-tune differ in the last bits without it."""
    cd = torch.backends.cudnn
    saved = cd.deterministic, cd.benchmark
    cd.deterministic, cd.benchmark = True, False
    try:
        yield
    finally:
        cd.deterministic, cd.benchmark = saved


@contextlib.contextmanager
def drawing_on(device):
    """Inside the block the models' init functions draw their random
    weights on ``device``, whatever their generator's device: on
    ``"meta"`` they build shapes and dtypes only, with no memory and no
    values (the dry run's parameters)."""
    prev = getattr(_DRAW, "device", None)
    _DRAW.device = torch.device(device)
    try:
        yield
    finally:
        _DRAW.device = prev


def draw_device(gen: torch.Generator) -> torch.device:
    """Where an init function draws with ``gen``: its device, or the
    :func:`drawing_on` device inside that block."""
    return getattr(_DRAW, "device", None) or gen.device
