"""Public op wrappers for the merged-segment kernels.

Each ``*_op`` takes the JAX package's layouts (NHWC activations, HWIO
weights; ``(..., D)`` activations and ``(D, R)``/``(R, D)`` factors for
the rank-r residual; ``(..., D)`` rows for the norm, ``(B, S, H, D)``
attention, ``(B, S, C)`` scans) and dispatches on where its input lies:

* a CPU tensor runs the op's plain PyTorch version (:mod:`.ref`) — this is
  how the CPU tests hold the port against the JAX package; so does a
  ``meta`` tensor, which computes shapes only (the dry run,
  :mod:`repro_torch.launch.dryrun`, counts the step's operations there);
* a CUDA tensor launches the hand-written kernel, or raises.  There is no
  fallback: a kernel that fails to build or launch is an error.

The quantized paths (``w_scale`` / ``u_scale`` / ``act_quant``) launch
each kernel's quantized variant on the card (narrow weights, fp32 sums,
the per-channel scale applied after the sum) and the plain ``*_qref``
versions on the CPU.  With ``act_quant="w8a8"`` the op quantizes the
activation per tensor (:func:`.quant.quantize_int8`) and folds its scale
into the weight's channel scale — plain PyTorch on the device, as the
JAX package does it with ``jnp`` outside its Pallas kernels.  The scale
never leaves the device: the kernel reads the folded vector from device
memory, so the op makes no host sync and can be captured in a CUDA graph.

The norm, scan and attention ops take their CUDA operands as they are:
a non-contiguous CUDA tensor, or one of a dtype the kernel has no body
for, raises; it is never copied or cast behind the caller's back.  The
norm and the attention have an fp32 and a bf16 body (the TPU kernels'
function at either dtype: fp32 inside, the input's dtype out); the scan
takes fp32 only, as the JAX package's RG-LRU block feeds it at every
dtype.

Gradients: on the card every op is differentiable.  The scan's backward
is a kernel of its own (:class:`_ScanGrad`: the forward kernel saves a and
its output h, the backward kernel reads them and the output's gradient
once, recomputing nothing), the gradient the JAX package takes through
XLA.  Every other op's backward is the gradient of its plain version (its
CPU branch, the ``*_qref`` one for a quantized body), recomputed from the
saved inputs (:class:`_PlainGrad`): the JAX package's design for
``flash_attention_op`` (``_fa_bwd``), with no backward kernel.  When no
input requires a gradient (``torch.no_grad()``, a captured inference
step) the op launches the forward kernel alone and records nothing.

Launch counts: each kernel wrapper adds one to its module's ``launches``
(fp32), ``launches_q`` (quantized variant), ``launches_bf16`` (bf16
body) or ``launches_bwd`` (the scan's backward) per launch it makes;
:func:`launch_counts` reads them and :func:`reset_launch_counts` sets them
to zero, so a run can show that its path went through the kernels.  They
count wrapper calls on the host: a step captured in a CUDA graph counts
its launches once, at the capture, and not at each replay (the serving
layer records the capture's counts as one step's launches).
"""
from __future__ import annotations

import torch

from . import depthwise_conv as _dw
from . import flash_attention as _fa
from . import merged_conv as _mc
from . import merged_ffn as _mf
from . import quant, ref
from . import rglru_scan as _rg
from . import rmsnorm as _rn


def _on_cuda(x: torch.Tensor, name: str) -> bool:
    if x.device.type in ("cpu", "meta"):
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


def _quantized_activation(x, scale, act_quant: str, reduce_amax=None):
    """``(x, scale)`` as the quantized kernels take them: under w8a8 the
    int8 activation and the channel scale times its per-tensor scale (both
    computed on x's device; ``reduce_amax``, where x is a shard, makes the
    per-tensor scale the whole tensor's), else ``x`` and the channel scale
    in fp32."""
    scale = scale.float()
    if act_quant == "w8a8":
        x, x_scale = quant.quantize_int8(x, reduce_amax=reduce_amax)
        scale = scale * x_scale
    return x, scale.contiguous()


class _PlainGrad(torch.autograd.Function):
    """``kernel(*inputs)`` forward, the gradient of ``plain(*inputs)``
    backward, recomputed from the saved inputs (None inputs pass
    through; integer ones take no gradient)."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, g):
        wanted = ctx.needs_input_grad[2:]
        leaves = [t if t is None else t.detach().requires_grad_(w)
                  for t, w in zip(ctx.saved_tensors, wanted)]
        with torch.enable_grad():
            out = ctx.plain(*leaves)
        grads = iter(torch.autograd.grad(
            out, [t for t, w in zip(leaves, wanted) if w], g,
            allow_unused=True))
        return (None, None, *(next(grads) if w else None for w in wanted))


def _launch(kernel, plain, *inputs):
    """``kernel(*inputs)``, differentiable as ``plain`` is whenever an input
    requires a gradient; otherwise the kernel alone, with nothing saved."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return _PlainGrad.apply(kernel, plain, *inputs)
    return kernel(*inputs)


def merged_conv_op(x, w, b=None, *, stride: int = 1,
                   activation: str | None = None, w_scale=None,
                   act_quant: str = "none", reduce_amax=None, plan_as=None):
    """Merged-segment conv (VALID, stride ``s``) with fused bias + boundary
    activation.  ``w_scale`` (per-output-channel) marks ``w`` as narrow;
    ``act_quant="w8a8"`` also quantizes the activation per tensor (over
    the whole tensor where ``x`` is a shard: ``reduce_amax``, see
    :func:`.quant.quantize_int8`).  ``plan_as`` ``(n, cout)``: x and w are
    a rank's block of a batch-``n``, ``cout``-channel product, launched
    with that product's plan (the kernel's
    :func:`.merged_conv.plan_as_block`; the plain version ignores it)."""
    def plain(x, w, b, w_scale):
        if w_scale is not None:
            y = ref.merged_conv_qref(x, w, b, w_scale, stride=stride,
                                     act_quant=act_quant,
                                     reduce_amax=reduce_amax)
        else:
            y = ref.merged_conv_ref(x, w, b, stride=stride)
        return ref.apply_activation(y, activation)

    def kernel(x, w, b, w_scale):
        ws = None
        if w_scale is not None:
            x, ws = _quantized_activation(x, w_scale, act_quant, reduce_amax)
        return _mc.merged_conv(x.contiguous(), w.contiguous(),
                               None if b is None else b.contiguous(),
                               stride=stride, activation=activation,
                               w_scale=ws, plan_as=plan_as)
    if not _on_cuda(x, "merged_conv_op"):
        return plain(x, w, b, w_scale)
    return _launch(kernel, plain, x, w, b, w_scale)


def depthwise_conv_op(x, w, b=None, *, stride: int = 1,
                      groups: int | None = None,
                      activation: str | None = None, w_scale=None,
                      act_quant: str = "none", reduce_amax=None):
    """Grouped/depthwise merged-segment conv (VALID, stride ``s``) with
    fused bias + boundary activation.  ``groups`` defaults to the
    depthwise reading ``Cin // Cin_g`` of the HWIO weight;
    ``reduce_amax`` as for :func:`merged_conv_op`."""
    if groups is None:
        groups = x.shape[-1] // w.shape[2]

    def plain(x, w, b, w_scale):
        if w_scale is not None:
            y = ref.depthwise_conv_qref(x, w, b, w_scale, stride=stride,
                                        groups=groups, act_quant=act_quant,
                                        reduce_amax=reduce_amax)
        else:
            y = ref.depthwise_conv_ref(x, w, b, stride=stride, groups=groups)
        return ref.apply_activation(y, activation)

    def kernel(x, w, b, w_scale):
        ws = None
        if w_scale is not None:
            x, ws = _quantized_activation(x, w_scale, act_quant, reduce_amax)
        return _dw.depthwise_conv(x.contiguous(), w.contiguous(),
                                  None if b is None else b.contiguous(),
                                  stride=stride, groups=groups,
                                  activation=activation, w_scale=ws)
    if not _on_cuda(x, "depthwise_conv_op"):
        return plain(x, w, b, w_scale)
    return _launch(kernel, plain, x, w, b, w_scale)


def merged_ffn_op(x, u, v, *, u_scale=None, v_scale=None,
                  act_quant: str = "none", residual: bool = True,
                  reduce_amax=None):
    """``(..., D)`` rank-r residual ``x + (x@U)@V``.  ``u_scale``
    (per-rank-column) and ``v_scale`` (per-output-column) mark ``u``/``v``
    as narrow; ``act_quant="w8a8"`` also quantizes the activation feeding
    the two products (the residual stays the fp32 ``x``; ``reduce_amax``
    as for :func:`merged_conv_op`).  ``residual=False`` leaves ``x`` out:
    ``(x@U)@V``, a rank's partial when U's columns and V's rows are split.
    On the card the fp32 kernel takes fp32 only: another dtype raises, it
    is never upcast silently."""
    def plain(x, u, v, u_scale, v_scale):
        if u_scale is not None:
            return ref.merged_ffn_qref(x, u, v, u_scale, v_scale,
                                       act_quant=act_quant,
                                       residual=residual,
                                       reduce_amax=reduce_amax)
        return ref.merged_ffn_ref(x, u, v, residual)

    def kernel(x, u, v, u_scale, v_scale):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).contiguous()
        if u_scale is None:
            return _mf.merged_ffn(x2, u.contiguous(), v.contiguous(),
                                  residual=residual).reshape(shape)
        xq, us = _quantized_activation(x2, u_scale, act_quant, reduce_amax)
        return _mf.merged_ffn(x2, u.contiguous(), v.contiguous(), u_scale=us,
                              v_scale=v_scale.float().contiguous(),
                              xq=None if xq is x2 else xq.contiguous(),
                              residual=residual).reshape(shape)
    if not _on_cuda(x, "merged_ffn_op"):
        return plain(x, u, v, u_scale, v_scale)
    return _launch(kernel, plain, x, u, v, u_scale, v_scale)


def rmsnorm_op(x, g, *, eps: float = 1e-6):
    """``x · rsqrt(mean x² + eps) · (1 + g)`` over the last axis of ``x``
    (any leading shape), in fp32, cast to ``x.dtype``.  On the card x and
    g must be contiguous: x fp32 with g fp32 (the fp32 body), or x bf16
    with g bf16 or fp32 (the bf16 body)."""
    def plain(x, g):
        return ref.rmsnorm_ref(x, g, eps)

    def kernel(x, g):
        if not x.is_contiguous():          # before the (M, D) view
            raise ValueError(f"rmsnorm_op: the CUDA kernel takes contiguous "
                             f"operands, got strides {x.stride()}")
        shape = x.shape
        return _rn.rmsnorm(x.view(-1, shape[-1]), g, eps).view(shape)
    if not _on_cuda(x, "rmsnorm_op"):
        return plain(x, g)
    return _launch(kernel, plain, x, g)


class _ScanGrad(torch.autograd.Function):
    """The scan's forward kernel, and its backward kernel for the
    gradient: a and the output h saved (the memory that a and b would
    take), one backward launch, nothing recomputed."""

    @staticmethod
    def forward(ctx, a, b):
        h = _rg.rglru_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        da, db = _rg.rglru_scan_bwd(a, h, g.contiguous())
        return (da if ctx.needs_input_grad[0] else None,
                db if ctx.needs_input_grad[1] else None)


def rglru_scan_op(a, b):
    """``h_t = a_t ⊙ h_{t-1} + b_t`` over axis 1 of (B, S, C), h₀ = 0,
    fp32.  On the card a and b must be contiguous fp32; the gradient is
    the backward kernel's."""
    if not _on_cuda(a, "rglru_scan_op"):
        return ref.rglru_scan_ref(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _ScanGrad.apply(a, b)
    return _rg.rglru_scan(a, b)


def _attention_plain(q, k, v, causal):
    """The plain version on k and v repeated to q's heads in the grouping
    of the transformer's attention: query head h reads kv head
    ``h // (H / KVH)``."""
    group = q.shape[2] // k.shape[2]
    return ref.flash_attention_ref(q, k.repeat_interleave(group, dim=2),
                                   v.repeat_interleave(group, dim=2),
                                   causal=causal)


def flash_attention_op(q, k, v, causal: bool = True):
    """Softmax attention over (B, S, H, D) q and (B, S, KVH, D) k, v with
    KVH dividing H (the JAX op's contract when KVH == H: it equals the
    plain version on k and v expanded to H heads).  On the card the
    operands must be contiguous and all fp32 (the fp32 body) or all bf16
    (the bf16 body)."""
    causal = bool(causal)

    def plain(q, k, v):
        return _attention_plain(q, k, v, causal)
    if not _on_cuda(q, "flash_attention_op"):
        return plain(q, k, v)
    return _launch(lambda q, k, v: _fa.flash_attention(q, k, v, causal),
                   plain, q, k, v)


def launch_counts() -> dict[str, int]:
    """Kernel launches in this process since the last reset: each fp32
    kernel, (``*_q``) the quantized variants and (``*_bf16``) the bf16
    bodies, and the scan's backward (``rglru_scan_bwd``).  Wrapper calls:
    a CUDA graph's replays add nothing."""
    return {"merged_conv": _mc.launches, "depthwise_conv": _dw.launches,
            "merged_ffn": _mf.launches, "merged_conv_q": _mc.launches_q,
            "depthwise_conv_q": _dw.launches_q,
            "merged_ffn_q": _mf.launches_q, "rmsnorm": _rn.launches,
            "rglru_scan": _rg.launches, "flash_attention": _fa.launches,
            "rmsnorm_bf16": _rn.launches_bf16,
            "flash_attention_bf16": _fa.launches_bf16,
            "rglru_scan_bwd": _rg.launches_bwd}


def reset_launch_counts() -> None:
    for mod in (_mc, _dw, _mf):
        mod.launches = 0
        mod.launches_q = 0
    for mod in (_rn, _rg, _fa):
        mod.launches = 0
    for mod in (_rn, _fa):
        mod.launches_bf16 = 0
    _rg.launches_bwd = 0
