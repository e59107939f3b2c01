"""A gradient through every kernel op's CUDA branch, seen on the CPU.

``ops._on_cuda`` is patched to True and each kernel entry point to a
stand-in that computes the op under ``torch.no_grad()`` — as a ctypes
launch does, invisible to autograd — and counts its calls.  So the op's
CUDA branch runs here exactly as on the card, apart from the arithmetic
of the kernel itself.  Each case requires:

* the output has a ``grad_fn`` whenever an input requires a gradient, and
  every gradient equals the plain version's autograd (``torch.equal``: the
  backward is the plain version's gradient, recomputed from the same
  inputs; the scan's is its backward kernel, whose stand-in is the
  backward's plain version ``rglru_scan_bwd_ref``, bitwise that autograd);
* the forward launches the kernel once; the backward launches the scan's
  backward kernel once and no other kernel;
* under ``torch.no_grad()``, and when no input requires a gradient, the op
  launches once and saves no tensor (no ``saved_tensors_hooks`` pack).

The quantized bodies take the gradient of their ``*_qref`` (``round`` has
a zero gradient there, as on the CPU path).  Forward outputs of the
stand-ins agree with the plain versions to 1e-5 (fp32 sums in another
order for the quantized stand-ins).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import depthwise_conv as _dw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import merged_conv as _mc
from repro_torch.kernels import merged_ffn as _mf
from repro_torch.kernels import ops, quant, ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import rmsnorm as _rn


def _conv_kernel(x, w, b=None, *, stride=1, activation=None, w_scale=None,
                 groups=1, plan_as=None):
    y = ref._conv_nhwc(x.float(), w.float(), stride, groups)
    if w_scale is not None:
        y = y * w_scale
    if b is not None:
        y = y + b
    return ref.apply_activation(y, activation)


def _ffn_kernel(x, u, v, *, u_scale=None, v_scale=None, xq=None,
                residual=True):
    if u_scale is None:
        return ref.merged_ffn_ref(x, u, v, residual)
    xin = x if xq is None else xq
    h = (xin.float() @ u.float()) * u_scale
    y = (h @ v.float()) * v_scale
    return x + y if residual else y


STAND_INS = {
    (_mc, "merged_conv"): _conv_kernel,
    (_dw, "depthwise_conv"): _conv_kernel,
    (_mf, "merged_ffn"): _ffn_kernel,
    (_rn, "rmsnorm"): lambda x, g, eps: ref.rmsnorm_ref(x, g, eps),
    (_rg, "rglru_scan"): ref.rglru_scan_ref,
    (_rg, "rglru_scan_bwd"): ref.rglru_scan_bwd_ref,
    (_fa, "flash_attention"): ops._attention_plain,
}


@pytest.fixture
def launches(monkeypatch):
    """The CUDA branch on the CPU: ``_on_cuda`` is True and every kernel
    entry a no-grad stand-in; returns the per-kernel call counts."""
    counts = {name: 0 for _, name in STAND_INS}

    def stand_in(name, fn):
        def launch(*args, **kw):
            counts[name] += 1
            with torch.no_grad():
                return fn(*args, **kw)
        return launch
    monkeypatch.setattr(ops, "_on_cuda", lambda x, name: True)
    for (mod, name), fn in STAND_INS.items():
        monkeypatch.setattr(mod, name, stand_in(name, fn))
    return counts


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))


def _cases():
    """``name -> (kernel, make(rng) -> (args, kwargs), plain(*args, **kw))``
    with the differentiable inputs first in ``args``."""
    def conv(dw, wq=None, aq="none"):
        def make(rng):
            c = 6
            x = _t(rng, 2, 9, 8, c)
            w = _t(rng, 3, 3, 1 if dw else c, c, scale=0.3)
            b = _t(rng, c, scale=0.1)
            kw = {"stride": 2, "activation": "relu6"}
            if wq is not None:
                w, ws = quant.quantize_weight(w, wq, axis=3)
                return (x, b, ws), dict(kw, w=w, act_quant=aq)
            return (x, w, b), kw
        return make

    def conv_call(op):
        def call(*args, **kw):
            if "w" in kw:
                x, b, ws = args
                return op(x, kw.pop("w"), b, w_scale=ws, **kw)
            return op(*args, **kw)
        return call

    def conv_plain(qref, fref, dw):
        def plain(*args, stride, activation, w=None, act_quant="none"):
            if w is not None:
                x, b, ws = args
                y = qref(x, w, b, ws, stride=stride, act_quant=act_quant)
            else:
                y = fref(*args, stride=stride)
            return ref.apply_activation(y, activation)
        return plain

    def ffn(q=None, aq="none"):
        def make(rng):
            x = _t(rng, 2, 5, 16)
            u = _t(rng, 16, 8, scale=0.25)
            v = _t(rng, 8, 16, scale=0.35)
            if q is None:
                return (x, u, v), {}
            uq, us = quant.quantize_weight(u, q, axis=1)
            vq, vs = quant.quantize_weight(v, q, axis=1)
            return (x, us, vs), dict(u=uq, v=vq, act_quant=aq)
        return make

    def ffn_call(*args, **kw):
        if "u" in kw:
            x, us, vs = args
            return ops.merged_ffn_op(x, kw["u"], kw["v"], u_scale=us,
                                     v_scale=vs, act_quant=kw["act_quant"])
        return ops.merged_ffn_op(*args)

    def ffn_plain(*args, **kw):
        if "u" in kw:
            x, us, vs = args
            return ref.merged_ffn_qref(x, kw["u"], kw["v"], us, vs,
                                       act_quant=kw["act_quant"])
        return ref.merged_ffn_ref(*args)

    def attention(rng):
        return (_t(rng, 2, 7, 4, 8), _t(rng, 2, 7, 2, 8),
                _t(rng, 2, 7, 2, 8)), {"causal": True}

    mc = conv_plain(ref.merged_conv_qref, ref.merged_conv_ref, False)
    dwp = conv_plain(ref.depthwise_conv_qref, ref.depthwise_conv_ref, True)
    cases = {
        "merged_conv": ("merged_conv", conv(False),
                        conv_call(ops.merged_conv_op), mc),
        "depthwise_conv": ("depthwise_conv", conv(True),
                           conv_call(ops.depthwise_conv_op), dwp),
        "merged_ffn": ("merged_ffn", ffn(), ffn_call, ffn_plain),
        "rmsnorm": ("rmsnorm",
                    lambda rng: ((_t(rng, 3, 5, 32), _t(rng, 32, scale=0.1)),
                                 {}),
                    ops.rmsnorm_op, lambda x, g: ref.rmsnorm_ref(x, g)),
        "rglru_scan": ("rglru_scan",
                       lambda rng: ((torch.sigmoid(_t(rng, 2, 6, 8)),
                                     _t(rng, 2, 6, 8)), {}),
                       ops.rglru_scan_op, ref.rglru_scan_ref),
        "flash_attention": ("flash_attention", attention,
                            ops.flash_attention_op,
                            lambda q, k, v, causal: ops._attention_plain(
                                q, k, v, causal)),
    }
    for mode, aq in (("int8", "none"), ("int8", "w8a8"), ("fp8", "none")):
        tag = f"{mode}-{aq}"
        cases[f"merged_conv_q-{tag}"] = (
            "merged_conv", conv(False, mode, aq),
            conv_call(ops.merged_conv_op), mc)
        cases[f"depthwise_conv_q-{tag}"] = (
            "depthwise_conv", conv(True, mode, aq),
            conv_call(ops.depthwise_conv_op), dwp)
        cases[f"merged_ffn_q-{tag}"] = ("merged_ffn", ffn(mode, aq),
                                        ffn_call, ffn_plain)
    return cases


CASES = _cases()


def _leaves(args):
    return [a.clone().requires_grad_() for a in args]


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradient_through_the_kernel_branch(case, launches):
    kernel, make, call, plain = CASES[case]
    args, kw = make(np.random.default_rng(len(case)))
    leaves = _leaves(args)
    y = call(*leaves, **dict(kw))
    assert launches[kernel] == 1
    assert y.grad_fn is not None, f"{case}: output cut off from autograd"
    ref_leaves = _leaves(args)
    y_ref = plain(*ref_leaves, **dict(kw))
    np.testing.assert_allclose(y.detach().numpy(), y_ref.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        tuple(y.shape)).astype(np.float32))
    got = torch.autograd.grad(y, leaves, g, allow_unused=True)
    want = torch.autograd.grad(y_ref, ref_leaves, g, allow_unused=True)
    assert launches[kernel] == 1, "the backward launched the kernel"
    assert launches["rglru_scan_bwd"] == (kernel == "rglru_scan"), \
        "the scan's backward kernel: one launch in its backward, else none"
    for n, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None), (case, n)
        if a is not None:
            assert torch.equal(a, b), (case, n, float((a - b).abs().max()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_grad_launches_once_and_saves_nothing(case, launches):
    kernel, make, call, _ = CASES[case]
    args, kw = make(np.random.default_rng(len(case)))
    packed = []

    def pack(t):
        packed.append(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with torch.no_grad():
            y = call(*_leaves(args), **dict(kw))
        assert y.grad_fn is None
        y2 = call(*args, **dict(kw))       # grad on, no input requires it
        assert y2.grad_fn is None
    assert launches[kernel] == 2
    assert packed == []
