"""Symmetric quantization primitives — the port's copy of ONE rounding rule.

Same semantics as the JAX package's ``kernels/quant.py``:
``x ≈ q.float() * scale`` with ``scale = max(amax, 1e-30) / 127`` for int8
(``q ∈ [-127, 127]``), per-tensor (``axis=None``, scalar scale) or
per-channel (``axis=i``, one scale per slice along axis ``i``).
``torch.round`` rounds half to even, as ``jnp.round`` does, so the two
packages produce the same integers from the same floats.  The scale is a
true division by a tensor of 127 (or 448) on the input's device: PyTorch's
CUDA division by a Python number multiplies by its reciprocal, which
differs from the division in the last bit for some inputs, so codes and
scales would differ between the card and the CPU.

fp8 (``float8_e4m3fn``) scales by ``amax / 448`` (the e4m3 finite max);
the cast rounds to nearest even.

Error budgets: ``error_budget(mode, fan_in, x_absmax, w_absmax)`` is the
worst-case absolute output error of a reduction over ``fan_in``
multiply-accumulates — each int8 weight carries at most ``scale/2``
error; w8a8 adds the activation term; fp8-e4m3 has at most 2^-4 relative
error per weight.  They are bounds, not tuned tolerances.
"""
from __future__ import annotations

import torch

INT8_QMAX = 127.0
FP8_E4M3_MAX = 448.0

#: Quantization modes understood by the planner/kernels.  "none" = fp.
MODES = ("none", "int8", "w8a8", "fp8")

#: Modes where the WEIGHT operand is narrow (all non-fp modes).
WEIGHT_NARROW = ("int8", "w8a8", "fp8")

#: Modes where the ACTIVATION operand is narrow too.
ACT_NARROW = ("w8a8",)


def _amax(x: torch.Tensor, axis):
    a = x.abs().float()
    if axis is None:
        return a.max()
    reduce_axes = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
    return a.amax(dim=reduce_axes)


def _divisor(scale: torch.Tensor, ndim: int, axis):
    if axis is None:
        return scale
    shape = [1] * ndim
    shape[axis % ndim] = -1
    return scale.reshape(shape)


def _scale(x: torch.Tensor, axis, qmax: float,
           reduce_amax=None) -> torch.Tensor:
    amax = _amax(x, axis)
    if reduce_amax is not None:
        amax = reduce_amax(amax)
    amax = torch.clamp(amax, min=1e-30)
    return amax / torch.full_like(amax, qmax)


def quantize_int8(x: torch.Tensor, axis: int | None = None, *,
                  reduce_amax=None):
    """Symmetric int8: returns ``(q, scale)`` (see module docstring).

    ``reduce_amax`` (a function of the local ``amax``) makes the scale
    a shard's of a tensor split across ranks: the sharded executor passes
    an ``all_reduce(MAX)`` over the axes the activation is split on, so
    every rank divides by the whole tensor's ``amax`` and its codes are
    bitwise the single device's block."""
    scale = _scale(x, axis, INT8_QMAX, reduce_amax)
    q = torch.clamp(torch.round(x.float() / _divisor(scale, x.ndim, axis)),
                    -INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), scale


def quantize_fp8(x: torch.Tensor, axis: int | None = None):
    """Symmetric float8_e4m3fn: same scale layout as int8; the cast's
    round-to-nearest-even does the rounding."""
    scale = _scale(x, axis, FP8_E4M3_MAX)
    q = (x.float() / _divisor(scale, x.ndim, axis)).to(torch.float8_e4m3fn)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, axis: int | None = None):
    """Dequantize any narrow dtype (int8 or fp8): ``q.float() * scale``."""
    return q.float() * _divisor(scale.float(), q.ndim, axis)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    axis: int | None = None):
    """Dequantize int8 codes: ``q.float() * scale`` (one scale, or one per
    slice along ``axis``), the inverse of :func:`quantize_int8`;
    :mod:`repro_torch.optim.compress` re-exports this object."""
    return q.float() * _divisor(scale.float(), q.ndim, axis)


def quantize_weight(w: torch.Tensor, mode: str, axis: int):
    """Quantize a weight tensor per-channel along ``axis`` for ``mode``.

    Returns ``(q, scale)``; mode "none" returns ``(w, None)``.
    """
    if mode == "none":
        return w, None
    if mode in ("int8", "w8a8"):
        return quantize_int8(w, axis=axis)
    if mode == "fp8":
        return quantize_fp8(w, axis=axis)
    raise ValueError(f"unknown quantization mode {mode!r}")


def error_budget(mode: str, *, fan_in: int, x_absmax: float,
                 w_absmax: float) -> float:
    """Worst-case |quantized − fp32| bound for one output of a reduction
    over ``fan_in`` multiply-accumulates (see module docstring)."""
    if mode == "none":
        return 0.0
    w_scale = max(w_absmax, 1e-30) / INT8_QMAX
    if mode == "int8":
        return fan_in * x_absmax * (w_scale / 2.0)
    if mode == "w8a8":
        x_scale = max(x_absmax, 1e-30) / INT8_QMAX
        return fan_in * (x_absmax * w_scale / 2.0
                         + w_absmax * x_scale / 2.0
                         + x_scale * w_scale / 4.0)
    if mode == "fp8":
        return fan_in * x_absmax * w_absmax * 2.0 ** -4
    raise ValueError(f"unknown quantization mode {mode!r}")


def weight_bytes(mode: str) -> int | None:
    """Weight byte width for the cost model (None = host default fp)."""
    return 1 if mode in WEIGHT_NARROW else None


def act_bytes(mode: str) -> int | None:
    """Activation byte width for the cost model (None = host default fp)."""
    return 1 if mode in ACT_NARROW else None
