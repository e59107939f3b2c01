"""The hand-written CUDA kernels on the card (marked ``cuda``; they skip
where ``torch.cuda.is_available()`` is false).  This file imports neither
JAX nor the JAX package, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernel vs plain version: ``rtol = atol = 1e-4`` (fp32 sums in another
order; an indexing fault is O(1)).  The quantized variants are held
against the plain ``*_qref`` versions on the same card inputs (the same
integer codes on both sides), with the same tolerance relative to the
largest output.  ``rmsnorm``, ``rglru_scan`` and ``flash_attention``: 1e-5
of the largest output (fp32 sums in another order; the scan rounds as its
plain version does and is held bitwise, its backward kernel too).  Their
bf16 bodies: each element within one bf16 ulp of the plain version (both
compute in fp32 and round once) and bitwise across two calls; the norm's bitwise the fp32 body's
output on the widened operands, rounded (the same arithmetic in the same
order); the attention's (a Hopper kernel of its own, summing in another
order) within one bf16 ulp of that output beyond the fp32 tolerance.  The
attention's one ulp is beyond its fp32 tolerance, since an output that
cancels to near zero differs by more than its own ulp between two fp32
sum orders.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch import kernels as tk

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import resolve
    return resolve("cuda")


def _data(seed, xshape, wshape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xshape).astype(np.float32)
    w = (rng.standard_normal(wshape) / np.sqrt(np.prod(wshape[:3]))
         ).astype(np.float32)
    b = rng.standard_normal(wshape[3]).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)


@pytest.mark.parametrize("stride,k", itertools.product((1, 2, 3),
                                                       (1, 2, 3, 5, 7, 11)))
def test_kernels_match_plain_versions(stride, k):
    dev = _card()
    before = tk.launch_counts()
    x, w, b = _data(k + stride, (2, k + 4 * stride, k + 3 * stride, 19),
                    (k, k, 19, 70))
    y = tk.merged_conv_op(x.to(dev), w.to(dev), b.to(dev), stride=stride,
                          activation="relu6")
    yr = tk.apply_activation(tk.merged_conv_ref(x, w, b, stride=stride),
                             "relu6")
    np.testing.assert_allclose(y.cpu().numpy(), yr.numpy(), rtol=1e-4,
                               atol=1e-4)
    for groups, cin_g, cout_g in ((13, 1, 1), (6, 1, 3), (3, 4, 5)):
        x, w, b = _data(k, (2, k + 4 * stride, k + 3 * stride,
                            groups * cin_g), (k, k, cin_g, groups * cout_g))
        y = tk.depthwise_conv_op(x.to(dev), w.to(dev), b.to(dev),
                                 stride=stride, groups=groups,
                                 activation="silu")
        yr = tk.apply_activation(tk.depthwise_conv_ref(
            x, w, b, stride=stride, groups=groups), "silu")
        np.testing.assert_allclose(y.cpu().numpy(), yr.numpy(), rtol=1e-4,
                                   atol=1e-4)
    after = tk.launch_counts()
    assert all(after[name] > before[name]
               for name in ("merged_conv", "depthwise_conv"))


@pytest.mark.parametrize("c", [4, 6, 960])
@pytest.mark.parametrize("stride,k", [(1, 3), (2, 3), (1, 1), (2, 5), (3, 1)])
def test_depthwise_conv_at_tile_boundaries(c, stride, k):
    """Depthwise channels 4 and 960 (the vector path) and 6 (the scalar
    one); Wo of 1 to 6 against the strip of 4 outputs; the compile-time
    instances (3×3 s1 / s2, 1×1 s1) and the runtime one; fp32 and w8a8."""
    dev = _card()
    for wo in range(1, 7):
        w_in = (wo - 1) * stride + k
        x, w, b = _data(c + wo + k, (2, k + 2 * stride, w_in, c),
                        (k, k, 1, c))
        x, w, b = x.to(dev), w.to(dev), b.to(dev)
        y = tk.depthwise_conv_op(x, w, b, stride=stride, groups=c,
                                 activation="relu6")
        _close_to(y, tk.apply_activation(tk.depthwise_conv_ref(
            x, w, b, stride=stride, groups=c), "relu6"))
        wq, ws = tk.quant.quantize_weight(w, "int8", axis=3)
        y = tk.depthwise_conv_op(x, wq, b, stride=stride, groups=c,
                                 w_scale=ws, act_quant="w8a8")
        _close_to(y, tk.depthwise_conv_qref(x, wq, b, ws, stride=stride,
                                            groups=c, act_quant="w8a8"))


@pytest.mark.parametrize("hw,c,stride", [(114, 32, 1), (30, 192, 2),
                                         (9, 960, 1)])
def test_depthwise_conv_is_bitwise_run_to_run(hw, c, stride):
    dev = _card()
    x, w, b = _data(c, (8, hw, hw, c), (3, 3, 1, c))
    x, w, b = x.to(dev), w.to(dev), b.to(dev)
    y = [tk.depthwise_conv_op(x, w, b, stride=stride, groups=c)
         for _ in range(2)]
    assert torch.equal(*y)
    wq, ws = tk.quant.quantize_weight(w, "int8", axis=3)
    y = [tk.depthwise_conv_op(x, wq, b, stride=stride, groups=c, w_scale=ws,
                              act_quant="w8a8") for _ in range(2)]
    assert torch.equal(*y)


@pytest.mark.parametrize("m,d,r", [(1, 32, 1), (8, 576, 576), (37, 96, 24),
                                   (130, 96, 1152), (1024, 576, 576),
                                   (5, 1100, 70), (3, 2100, 40)])
def test_merged_ffn_matches_plain_version(m, d, r):
    dev = _card()
    rng = np.random.default_rng(m + d + r)
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    u = torch.from_numpy((rng.standard_normal((d, r)) / np.sqrt(d))
                         .astype(np.float32))
    v = torch.from_numpy((rng.standard_normal((r, d)) / np.sqrt(r))
                         .astype(np.float32))
    before = tk.launch_counts()["merged_ffn"]
    y = tk.merged_ffn_op(x.to(dev), u.to(dev), v.to(dev))
    assert tk.launch_counts()["merged_ffn"] == before + 1
    yr = tk.merged_ffn_ref(x, u, v)
    np.testing.assert_allclose(y.cpu().numpy(), yr.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_merged_ffn_refuses_other_dtypes_and_scales():
    dev = _card()
    x = torch.ones(4, 32, device=dev)
    u, v = torch.ones(32, 8, device=dev), torch.ones(8, 32, device=dev)
    with pytest.raises(TypeError, match="float32"):
        tk.merged_ffn_op(x.bfloat16(), u.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError, match="u_scale"):
        tk.merged_ffn_op(x, u.to(torch.int8), v.to(torch.int8),
                         u_scale=torch.ones(9, device=dev),
                         v_scale=torch.ones(32, device=dev))
    with pytest.raises(TypeError, match="int8"):
        tk.merged_ffn_op(x, u, v, u_scale=torch.ones(8, device=dev),
                         v_scale=torch.ones(32, device=dev))


#: (weight mode of ``quant.quantize_weight``, the op's ``act_quant``)
QMODES = {"int8": ("int8", "none"), "w8a8": ("int8", "w8a8"),
          "fp8": ("fp8", "none")}


def _close_to(y, yr):
    """|y − yr| ≤ 1e-4 · max |yr| + 1e-4 (fp32 sums in another order)."""
    y, yr = y.cpu().numpy(), yr.cpu().numpy()
    assert y.shape == yr.shape and np.isfinite(y).all()
    assert np.abs(y - yr).max() <= 1e-4 * np.abs(yr).max() + 1e-4


@pytest.mark.parametrize("mode,stride,k", itertools.product(
    QMODES, (1, 2, 3), (1, 3, 5, 7)))
def test_quantized_kernels_match_plain_versions(mode, stride, k):
    dev = _card()
    wmode, aq = QMODES[mode]
    before = tk.launch_counts()
    x, w, b = _data(k + stride, (2, k + 4 * stride, k + 3 * stride, 19),
                    (k, k, 19, 70))
    x = x.to(dev)
    wq, ws = tk.quant.quantize_weight(w.to(dev), wmode, axis=3)
    y = tk.merged_conv_op(x, wq, b.to(dev), stride=stride, w_scale=ws,
                          act_quant=aq, activation="relu6")
    _close_to(y, tk.apply_activation(tk.merged_conv_qref(
        x, wq, b.to(dev), ws, stride=stride, act_quant=aq), "relu6"))
    for groups, cin_g, cout_g in ((13, 1, 1), (6, 1, 3), (3, 4, 5)):
        x, w, b = _data(k, (2, k + 4 * stride, k + 3 * stride,
                            groups * cin_g), (k, k, cin_g, groups * cout_g))
        x = x.to(dev)
        wq, ws = tk.quant.quantize_weight(w.to(dev), wmode, axis=3)
        y = tk.depthwise_conv_op(x, wq, None, stride=stride, groups=groups,
                                 w_scale=ws, act_quant=aq, activation="silu")
        _close_to(y, tk.apply_activation(tk.depthwise_conv_qref(
            x, wq, None, ws, stride=stride, groups=groups, act_quant=aq),
            "silu"))
    after = tk.launch_counts()
    assert after["merged_conv_q"] == before["merged_conv_q"] + 1
    assert after["depthwise_conv_q"] == before["depthwise_conv_q"] + 3
    assert after["merged_conv"] == before["merged_conv"]


@pytest.mark.parametrize("mode,m,d,r", [
    (mode, *shape) for mode in QMODES
    for shape in ((1, 96, 24), (8, 576, 576), (37, 96, 576), (1024, 576, 576),
                  (3, 1100, 70))])
def test_quantized_merged_ffn_matches_plain_version(mode, m, d, r):
    dev = _card()
    wmode, aq = QMODES[mode]
    rng = np.random.default_rng(m + d + r)
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    u = torch.from_numpy((rng.standard_normal((d, r)) / np.sqrt(d))
                         .astype(np.float32))
    v = torch.from_numpy((rng.standard_normal((r, d)) / np.sqrt(r))
                         .astype(np.float32))
    x = x.to(dev)
    uq, us = tk.quant.quantize_weight(u.to(dev), wmode, axis=1)
    vq, vs = tk.quant.quantize_weight(v.to(dev), wmode, axis=1)
    before = tk.launch_counts()["merged_ffn_q"]
    y = tk.merged_ffn_op(x, uq, vq, u_scale=us, v_scale=vs, act_quant=aq)
    assert tk.launch_counts()["merged_ffn_q"] == before + 1
    _close_to(y, tk.merged_ffn_qref(x, uq, vq, us, vs, act_quant=aq))


#: The quantized kernel's four type pairs: the weight mode and the op's
#: ``act_quant`` (w8a8: an int8 panel feeds P).
QPAIRS = {"fp32 x int8": ("int8", "none"), "int8 x int8": ("int8", "w8a8"),
          "fp32 x e4m3": ("fp8", "none"), "int8 x e4m3": ("fp8", "w8a8")}
#: RecurrentGemma-2B's width and a ragged one; decode, a ragged prefill and
#: a probe; a narrow rank, a merged unit and the unmerged GeGLU.
WIDE = [(m, d, r) for d in (2560, 2561) for m in (8, 65, 1024)
        for r in (24, 2560, 7680)]


def _ffn_factors(m, d, r, dev):
    g = torch.Generator().manual_seed(m + d + r)
    x = torch.randn(m, d, generator=g).to(dev)
    u = (torch.randn(d, r, generator=g) / d ** 0.5).to(dev)
    v = (torch.randn(r, d, generator=g) / r ** 0.5).to(dev)
    return x, u, v


def _within_scale(y, yr, x, xd, ud, vd):
    """|y − yr| ≤ 1e-4 · (|x| + (|x̂|·|Û|)·|V̂|) + 1e-6 per output: fp32
    sums in another order, over the (dequantized) operands."""
    scale = x.abs() + (xd.abs() @ ud.abs()) @ vd.abs()
    assert y.shape == yr.shape and bool(torch.isfinite(y).all())
    assert bool(((y - yr).abs() <= 1e-4 * scale + 1e-6).all()), \
        float(((y - yr).abs() / scale).max())


@pytest.mark.parametrize("m,d,r", WIDE)
def test_merged_ffn_wide_matches_plain_version(m, d, r):
    dev = _card()
    x, u, v = _ffn_factors(m, d, r, dev)
    before = tk.launch_counts()["merged_ffn"]
    y = tk.merged_ffn_op(x, u, v)
    assert tk.launch_counts()["merged_ffn"] == before + 1
    _within_scale(y, tk.merged_ffn_ref(x, u, v), x, x, u, v)


@pytest.mark.parametrize("pair", QPAIRS)
@pytest.mark.parametrize("m,d,r", WIDE)
def test_quantized_merged_ffn_wide_matches_plain_version(pair, m, d, r):
    dev = _card()
    wmode, aq = QPAIRS[pair]
    x, u, v = _ffn_factors(m, d, r, dev)
    uq, us = tk.quant.quantize_weight(u, wmode, axis=1)
    vq, vs = tk.quant.quantize_weight(v, wmode, axis=1)
    before = tk.launch_counts()["merged_ffn_q"]
    y = tk.merged_ffn_op(x, uq, vq, u_scale=us, v_scale=vs, act_quant=aq)
    assert tk.launch_counts()["merged_ffn_q"] == before + 1
    xd = tk.quant.dequantize(*tk.quant.quantize_int8(x)) if aq == "w8a8" \
        else x
    _within_scale(y, tk.merged_ffn_qref(x, uq, vq, us, vs, act_quant=aq),
                  x, xd, tk.quant.dequantize(uq, us, axis=1),
                  tk.quant.dequantize(vq, vs, axis=1))


#: The residual switch (a rank's partial of a split over the rank): the
#: shapes of both tiles, split and unsplit reductions, a ragged width.
PARTIAL = [(1, 576, 24), (8, 576, 288), (8, 2560, 1280), (65, 2561, 24),
           (1024, 576, 288)]


@pytest.mark.parametrize("pair", [None, *QPAIRS])
@pytest.mark.parametrize("m,d,r", PARTIAL)
def test_merged_ffn_without_residual_matches_plain_version(pair, m, d, r):
    """``residual=False``: ``(x̂·U)·V`` alone, within the residual tests'
    scale, and bitwise the same on a second call."""
    dev = _card()
    x, u, v = _ffn_factors(m, d, r, dev)
    kw, name, xd, ud, vd = {}, "merged_ffn", x, u, v
    if pair is not None:
        wmode, aq = QPAIRS[pair]
        u, us = tk.quant.quantize_weight(u, wmode, axis=1)
        v, vs = tk.quant.quantize_weight(v, wmode, axis=1)
        kw = dict(u_scale=us, v_scale=vs, act_quant=aq)
        name = "merged_ffn_q"
        xd = tk.quant.dequantize(*tk.quant.quantize_int8(x)) \
            if aq == "w8a8" else x
        ud = tk.quant.dequantize(u, us, axis=1)
        vd = tk.quant.dequantize(v, vs, axis=1)
    before = tk.launch_counts()[name]
    y = tk.merged_ffn_op(x, u, v, residual=False, **kw)
    y2 = tk.merged_ffn_op(x, u, v, residual=False, **kw)
    assert tk.launch_counts()[name] == before + 2
    assert torch.equal(y, y2)
    plain = (tk.merged_ffn_qref(x, u, v, us, vs, act_quant=aq,
                                residual=False) if pair is not None
             else tk.merged_ffn_ref(x, u, v, residual=False))
    _within_scale(y, plain, torch.zeros_like(x), xd, ud, vd)
    full = tk.merged_ffn_op(x, u, v, **kw)
    _within_scale(full - x, y, torch.zeros_like(x), xd, ud, vd)


@pytest.mark.parametrize("m,d,r", [(8, 2560, 2560), (1024, 2560, 2560),
                                   (65, 2561, 7680)])
def test_merged_ffn_is_bitwise_run_to_run(m, d, r):
    """The split reductions sum in a fixed order (no float atomics): two
    calls on the same inputs give the same bits, fp32 and w8a8."""
    dev = _card()
    x, u, v = _ffn_factors(m, d, r, dev)
    assert torch.equal(tk.merged_ffn_op(x, u, v), tk.merged_ffn_op(x, u, v))
    uq, us = tk.quant.quantize_weight(u, "int8", axis=1)
    vq, vs = tk.quant.quantize_weight(v, "int8", axis=1)
    ys = [tk.merged_ffn_op(x, uq, vq, u_scale=us, v_scale=vs,
                           act_quant="w8a8") for _ in range(2)]
    assert torch.equal(*ys)


def test_refused_merged_ffn_launch_raises(monkeypatch):
    """A launch the kernel refuses (here a plan with more splits than a
    cluster holds) raises; nothing falls back to the plain version and no
    launch is counted."""
    import dataclasses
    from repro_torch.kernels import merged_ffn as mf
    dev = _card()
    x, u, v = _ffn_factors(8, 256, 64, dev)
    good = mf.launch_plan(8, 256, 64)
    bad = dataclasses.replace(good, a=dataclasses.replace(
        good.a, splits=32, k_chunk=32))
    monkeypatch.setattr(mf, "launch_plan", lambda *a, **k: bad)
    before = tk.launch_counts()
    with pytest.raises(RuntimeError, match="merged_ffn"):
        tk.merged_ffn_op(x, u, v)
    uq, us = tk.quant.quantize_weight(u, "int8", axis=1)
    vq, vs = tk.quant.quantize_weight(v, "int8", axis=1)
    with pytest.raises(RuntimeError, match="merged_ffn_q"):
        tk.merged_ffn_op(x, uq, vq, u_scale=us, v_scale=vs)
    assert tk.launch_counts() == before


#: merged_conv's instances (x, w, stride): the Cin 3 stride-2 stem
#: (element gather), the dense 1x1 panel, a 3x3 stride-2 unit with Cout 24
#: (16-byte gather), Cin 24 (8-byte int8 gather), Cin 12 (4-byte), the
#: split 14x14 and 7x7 MobileNetV2 units on the 128 x 16 tile, the merged
#: 5x5 unit on 128 x 32, deep 3x3 units on 64 x 64 and 128 x 128 (split),
#: ragged Cout 70 (element copies of the weight).
CONV_INSTANCES = [((8, 17, 17, 3), (3, 3, 3, 32), 2),
                  ((2, 30, 31, 32), (1, 1, 32, 16), 1),
                  ((2, 23, 21, 16), (3, 3, 16, 24), 2),
                  ((2, 19, 18, 24), (1, 1, 24, 144), 1),
                  ((2, 12, 11, 12), (3, 3, 12, 20), 1),
                  ((8, 14, 14, 384), (1, 1, 384, 64), 1),
                  ((8, 7, 7, 576), (1, 1, 576, 160), 1),
                  ((8, 60, 60, 24), (5, 5, 24, 32), 2),
                  ((8, 30, 30, 128), (3, 3, 128, 128), 1),
                  ((4, 58, 58, 256), (3, 3, 256, 256), 1),
                  ((2, 9, 8, 19), (2, 2, 19, 70), 3)]
#: (x dtype, w dtype, act_quant) of the quantized body's four type pairs.
CONV_PAIRS = {"fp32 x int8": ("int8", "none"), "int8 x int8": ("int8", "w8a8"),
              "fp32 x e4m3": ("fp8", "none"), "int8 x e4m3": ("fp8", "w8a8")}


def _conv_scale(x, w, b, stride):
    """|x| ⋆ |w| + |b|: what a kernel's fp32 sums are held against."""
    return tk.merged_conv_ref(x.abs(), w.abs(), b.abs(), stride=stride)


def _conv_operands(xs, ws, dev):
    g = torch.Generator().manual_seed(sum(xs) + sum(ws))
    x = torch.randn(*xs, generator=g).to(dev)
    w = (torch.randn(*ws, generator=g) / (ws[0] * ws[2] ** 0.5)).to(dev)
    return x, w, torch.randn(ws[3], generator=g).to(dev)


@pytest.mark.parametrize("pair", [None, *CONV_PAIRS])
@pytest.mark.parametrize("xs,ws,stride", CONV_INSTANCES)
def test_merged_conv_instances_match_plain_versions(xs, ws, stride, pair):
    """Every tile, copy width, the dense panel, split reductions and the
    int8 mma: |Δ| <= 1e-4 · (|x̂| ⋆ |ŵ| + |b|) + 1e-6 per output."""
    dev = _card()
    x, w, b = _conv_operands(xs, ws, dev)
    if pair is None:
        y = tk.merged_conv_op(x, w, b, stride=stride, activation="silu")
        yr = tk.merged_conv_ref(x, w, b, stride=stride)
        scale = _conv_scale(x, w, b, stride)
    else:
        wmode, aq = CONV_PAIRS[pair]
        wq, wsc = tk.quant.quantize_weight(w, wmode, axis=3)
        y = tk.merged_conv_op(x, wq, b, stride=stride, w_scale=wsc,
                              act_quant=aq, activation="silu")
        yr = tk.merged_conv_qref(x, wq, b, wsc, stride=stride, act_quant=aq)
        xd = tk.quant.dequantize(*tk.quant.quantize_int8(x)) \
            if aq == "w8a8" else x
        scale = _conv_scale(xd, tk.quant.dequantize(wq, wsc, axis=3), b,
                            stride)
    yr = tk.apply_activation(yr, "silu")
    assert y.shape == yr.shape and bool(torch.isfinite(y).all())
    assert bool(((y - yr).abs() <= 1e-4 * scale + 1e-6).all()), \
        float(((y - yr).abs() / scale).max())


#: The DDPM UNet's distinct unit shapes at batch 8 (``zoo.ddpm_unet()``):
#: the Cin-4 stem, the Cout-3 output conv, the convs after the 768- and
#: 384-channel concats, and boundaries 3 to 6 merged into 11x11 stride 2.
UNET_UNITS = [((8, 34, 34, 4), (3, 3, 4, 128), 1),
              ((8, 34, 34, 128), (3, 3, 128, 3), 1),
              ((8, 18, 18, 768), (3, 3, 768, 256), 1),
              ((8, 34, 34, 384), (3, 3, 384, 128), 1),
              ((8, 42, 42, 128), (11, 11, 128, 256), 2)]


@pytest.mark.parametrize("xs,ws,stride", UNET_UNITS)
def test_merged_conv_at_unet_units_matches_plain_version(xs, ws, stride):
    """|Δ| <= 1e-4 · (|x| ⋆ |w| + |b|) + 1e-6 per output, with the UNet's
    SiLU epilogue."""
    dev = _card()
    x, w, b = _conv_operands(xs, ws, dev)
    tk.reset_launch_counts()
    y = tk.merged_conv_op(x, w, b, stride=stride, activation="silu")
    assert tk.launch_counts()["merged_conv"] == 1
    yr = tk.apply_activation(tk.merged_conv_ref(x, w, b, stride=stride),
                             "silu")
    scale = _conv_scale(x, w, b, stride)
    assert y.shape == yr.shape and bool(torch.isfinite(y).all())
    assert bool(((y - yr).abs() <= 1e-4 * scale + 1e-6).all()), \
        float(((y - yr).abs() / scale).max())


def test_merged_conv_int8_mma_stops_at_its_int32_range():
    """K = 2^17: int8 x int8 takes the TF32 instance (the int8 mma's int32
    sum could overflow), and still matches its plain version."""
    from repro_torch.kernels import merged_conv as mc
    dev = _card()
    assert not mc.launch_plan(1, 1, 3, 2 ** 17, 1, 1, 16, 1, 1, 1).s8
    assert mc.launch_plan(1, 1, 3, 2 ** 17 - 1, 1, 1, 16, 1, 1, 1).s8
    x, w, b = _conv_operands((1, 1, 3, 2 ** 17), (1, 1, 2 ** 17, 16), dev)
    wq, wsc = tk.quant.quantize_weight(w, "int8", axis=3)
    y = tk.merged_conv_op(x, wq, b, w_scale=wsc, act_quant="w8a8")
    yr = tk.merged_conv_qref(x, wq, b, wsc, act_quant="w8a8")
    xd = tk.quant.dequantize(*tk.quant.quantize_int8(x))
    scale = _conv_scale(xd, tk.quant.dequantize(wq, wsc, axis=3), b, 1)
    assert bool(((y - yr).abs() <= 1e-4 * scale + 1e-6).all())


@pytest.mark.parametrize("xs,ws,stride", [
    ((8, 226, 226, 3), (3, 3, 3, 32), 2), ((8, 56, 56, 24), (1, 1, 24, 144), 1),
    ((8, 14, 14, 384), (1, 1, 384, 64), 1), ((8, 7, 7, 576), (1, 1, 576, 160), 1)])
def test_merged_conv_is_bitwise_run_to_run(xs, ws, stride):
    """The split reductions sum in a fixed order (no float atomics): two
    calls on the same inputs give the same bits, fp32 and w8a8, at
    MobileNetV2 unit shapes."""
    dev = _card()
    x, w, b = _conv_operands(xs, ws, dev)
    assert torch.equal(tk.merged_conv_op(x, w, b, stride=stride),
                       tk.merged_conv_op(x, w, b, stride=stride))
    wq, wsc = tk.quant.quantize_weight(w, "int8", axis=3)
    ys = [tk.merged_conv_op(x, wq, b, stride=stride, w_scale=wsc,
                            act_quant="w8a8") for _ in range(2)]
    assert torch.equal(*ys)


def test_refused_merged_conv_launch_raises(monkeypatch):
    """A plan the kernel does not take (more splits than a cluster holds;
    the int8 mma past its int32 range) raises; nothing falls back and no
    launch is counted."""
    import dataclasses
    from repro_torch.kernels import merged_conv as mc
    dev = _card()
    x, w, b = _conv_operands((2, 14, 14, 384), (1, 1, 384, 64), dev)
    good = mc.launch_plan(2, 14, 14, 384, 1, 1, 64, 1)
    before = tk.launch_counts()
    for bad in (dataclasses.replace(good, splits=12, k_chunk=32),
                dataclasses.replace(good, bm=32)):
        monkeypatch.setattr(mc, "launch_plan", lambda *a, **k: bad)
        with pytest.raises(RuntimeError, match="merged_conv"):
            tk.merged_conv_op(x, w, b)
    wq, wsc = tk.quant.quantize_weight(w, "int8", axis=3)
    monkeypatch.setattr(mc, "launch_plan", lambda *a, **k: dataclasses.replace(
        good, s8=True))
    with pytest.raises(RuntimeError, match="merged_conv_q"):
        tk.merged_conv_op(x, wq, b, w_scale=wsc)       # fp32 x int8
    assert tk.launch_counts() == before


def test_w8a8_activation_quantization_stays_on_the_card():
    """The op quantizes the activation and folds its scale on the device:
    the whole quantized op can be captured in a CUDA graph (a host sync
    would fail the capture)."""
    dev = _card()
    x = torch.randn(8, 576, device=dev)
    uq, us = tk.quant.quantize_weight(torch.randn(576, 64, device=dev) / 24,
                                      "int8", axis=1)
    vq, vs = tk.quant.quantize_weight(torch.randn(64, 576, device=dev) / 8,
                                      "int8", axis=1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tk.merged_ffn_op(x, uq, vq, u_scale=us, v_scale=vs, act_quant="w8a8")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = tk.merged_ffn_op(x, uq, vq, u_scale=us, v_scale=vs,
                             act_quant="w8a8")
    graph.replay()
    _close_to(y, tk.merged_ffn_qref(x, uq, vq, us, vs, act_quant="w8a8"))


def test_quantize_int8_is_bitwise_the_cpus():
    dev = _card()
    x = torch.randn(64, 576, generator=torch.Generator().manual_seed(0)) * 3
    for axis in (None, 1):
        q, s_ = tk.quant.quantize_int8(x, axis=axis)
        qd, sd = tk.quant.quantize_int8(x.to(dev), axis=axis)
        assert torch.equal(qd.cpu(), q) and torch.equal(sd.cpu(), s_)


def test_tiny_network_on_the_card_matches_the_cpu(tmp_path):
    dev = _card()
    from repro_torch import runtime
    from repro_torch.compress import main
    out = str(tmp_path / "tm.npz")
    main(["--arch", "tiny_mobilenet", "--oracle", "wallclock", "--out", out])
    x = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    tk.reset_launch_counts()
    y = runtime.load(out).apply(x.to(dev))
    counts = tk.launch_counts()
    assert counts["merged_conv"] > 0 and counts["depthwise_conv"] > 0
    y_cpu = runtime.load(out, device="cpu").apply(x)
    np.testing.assert_allclose(y.cpu().numpy(), y_cpu.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_ddpm_unet_on_the_card_matches_the_cpu(tmp_path):
    """The whole DDPM UNet (full width, analytic tables) compressed and
    executed on the card: concat, GN, upsample and attention units around
    merged_conv, held against the same artifact on the CPU."""
    dev = _card()
    from repro_torch import runtime
    from repro_torch.compress import main
    out = str(tmp_path / "unet.npz")
    main(["--arch", "ddpm_unet", "--budget-ratio", "0.6", "--out", out])
    art = runtime.load(out)
    kinds = {u.kind for u in art.graph.units}
    assert {"conv", "upsample", "attn"} <= kinds
    x = torch.randn(2, 32, 32, 4, generator=torch.Generator().manual_seed(0))
    tk.reset_launch_counts()
    y = art.apply(x.to(dev))
    assert tk.launch_counts()["merged_conv"] > 0
    y_cpu = runtime.load(out, device="cpu").apply(x)
    assert tuple(y.shape) == (2, 32, 32, 3)
    assert float((y.cpu() - y_cpu).abs().max()) <= \
        1e-4 * float(y_cpu.abs().max())


def test_tiny_quantized_network_on_the_card(tmp_path):
    dev = _card()
    from repro_torch import runtime
    from repro_torch.compress import main
    out = str(tmp_path / "tq.npz")
    summary = main(["--arch", "tiny_mobilenet", "--quantize", "w8a8",
                    "--out", out])
    assert summary["quantized_units"] > 0
    x = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    tk.reset_launch_counts()
    y = runtime.load(out).apply(x.to(dev))
    assert tk.launch_counts()["depthwise_conv_q"] > 0
    y_cpu = runtime.load(out, device="cpu").apply(x)
    # an int8 code can differ by one step where fp32 reassociation moved
    # an activation across a rounding boundary: 1/127 of its range, rare
    np.testing.assert_allclose(y.cpu().numpy(), y_cpu.numpy(), rtol=1e-2,
                               atol=1e-2)


def test_tiny_lm_on_the_card_matches_the_cpu(tmp_path):
    dev = _card()
    from repro_torch import runtime
    from repro_torch.compress import main
    out = str(tmp_path / "lm.npz")
    main(["--arch", "smollm-135m", "--method", "depth", "--budget-ratio",
          "0.9", "--seq", "16", "--out", out])
    art = runtime.load(out)
    toks = torch.randint(0, 64, (2, 6),
                         generator=torch.Generator().manual_seed(0))
    tk.reset_launch_counts()
    y = art.apply({"tokens": toks})
    assert tk.launch_counts()["merged_ffn"] > 0
    y_cpu = runtime.load(out, device="cpu").apply({"tokens": toks})
    np.testing.assert_allclose(y.cpu().numpy(), y_cpu.numpy(), rtol=1e-4,
                               atol=1e-4)


def _rel(y, yr):
    y, yr = y.cpu(), yr.cpu()
    assert y.shape == yr.shape and bool(torch.isfinite(y).all())
    return float((y - yr).abs().max() / yr.abs().max())


@pytest.mark.parametrize("m,d", [(8, 2560), (37, 2561)])
def test_rmsnorm_matches_plain_version(m, d):
    dev = _card()
    g = torch.Generator().manual_seed(m + d)
    x = (torch.randn(m, d, generator=g) * 3).to(dev)
    w = (torch.randn(d, generator=g) * 0.2).to(dev)
    before = tk.launch_counts()["rmsnorm"]
    y = tk.rmsnorm_op(x, w, eps=1e-6)
    assert tk.launch_counts()["rmsnorm"] == before + 1
    assert _rel(y, tk.rmsnorm_ref(x, w, 1e-6)) <= 1e-5


@pytest.mark.parametrize("b,s,c", [(8, 128, 2560), (1, 7, 2561)])
def test_rglru_scan_matches_plain_version(b, s, c):
    dev = _card()
    g = torch.Generator().manual_seed(b + s + c)
    a = (torch.rand(b, s, c, generator=g) * 0.5 + 0.5).to(dev)
    x = torch.randn(b, s, c, generator=g).to(dev)
    before = tk.launch_counts()["rglru_scan"]
    h = tk.rglru_scan_op(a, x)
    assert tk.launch_counts()["rglru_scan"] == before + 1
    assert torch.equal(h, tk.rglru_scan_ref(a, x))


@pytest.mark.parametrize("b,s,c", [(8, 128, 2560), (1, 7, 2561),
                                   (2, 130, 37), (1, 1, 32)])
def test_rglru_scan_bwd_matches_plain_version(b, s, c):
    """The backward kernel bitwise its plain version (the reverse loop) and
    the plain version's autograd, one launch."""
    from repro_torch.kernels import rglru_scan as rg
    dev = _card()
    g = torch.Generator().manual_seed(b + s + c + 1)
    a = (torch.rand(b, s, c, generator=g) * 0.5 + 0.5).to(dev)
    x = torch.randn(b, s, c, generator=g).to(dev)
    w = torch.randn(b, s, c, generator=g).to(dev)
    h = tk.rglru_scan_ref(a, x)
    before = tk.launch_counts()["rglru_scan_bwd"]
    da, db = rg.rglru_scan_bwd(a, h, w)
    assert tk.launch_counts()["rglru_scan_bwd"] == before + 1
    want = tk.rglru_scan_bwd_ref(a, h, w)
    assert torch.equal(da, want[0]) and torch.equal(db, want[1])
    leaves = [a.clone().requires_grad_(), x.clone().requires_grad_()]
    ga, gx = torch.autograd.grad(tk.rglru_scan_ref(*leaves), leaves, w)
    assert torch.equal(da, ga) and torch.equal(db, gx)


@pytest.mark.parametrize("shape,kvh,causal", [
    ((8, 128, 10, 256), 1, True), ((2, 37, 9, 64), 3, False),
    ((1, 7, 2, 32), 2, True)])
def test_flash_attention_matches_plain_version(shape, kvh, causal):
    dev = _card()
    b, s, h, d = shape
    g = torch.Generator().manual_seed(s + d)
    q = torch.randn(b, s, h, d, generator=g).to(dev)
    k, v = (torch.randn(b, s, kvh, d, generator=g).to(dev) for _ in range(2))
    before = tk.launch_counts()["flash_attention"]
    y = tk.flash_attention_op(q, k, v, causal)
    assert tk.launch_counts()["flash_attention"] == before + 1
    ke, ve = (t.repeat_interleave(h // kvh, dim=2) for t in (k, v))
    assert _rel(y, tk.flash_attention_ref(q, ke, ve, causal)) <= 1e-5


@pytest.mark.parametrize("g", [1, 3, 10])
@pytest.mark.parametrize("d", [32, 64, 100, 256])
def test_flash_attention_at_tile_boundaries(g, d, monkeypatch):
    """S at each q-tile size (16, 32, 64 rows of the s-major (s, head)
    rows; kv tiles of 16 or 32 keys) -1, +0, +1, head groups of 1, 3 and
    10 query heads a kv head, ragged D 100, through every instance of the
    head-dim tile (row groups a block, column splits): the launch plan
    is set to each in turn."""
    dev = _card()
    from repro_torch.kernels import flash_attention as fa
    dp = fa.head_dim_tile(d)
    plans = [(wr, 1) for wr in fa.ROW_GROUPS[dp]] + [(1, 2)]
    for wr, dsplit in plans:
        monkeypatch.setattr(fa, "launch_plan", lambda *a, **k: fa.LaunchPlan(
            *a[:5], wr, dsplit))
        for s in (15, 16, 17, 31, 32, 33, 63, 64, 65):
            gen = torch.Generator().manual_seed(s * g + d)
            kvh = 2 if g < 10 else 1
            q = torch.randn(2, s, g * kvh, d, generator=gen).to(dev)
            k, v = (torch.randn(2, s, kvh, d, generator=gen).to(dev)
                    for _ in range(2))
            causal = s % 2 == 1
            y = tk.flash_attention_op(q, k, v, causal)
            ke, ve = (t.repeat_interleave(g, dim=2) for t in (k, v))
            assert _rel(y, tk.flash_attention_ref(q, ke, ve, causal)) \
                <= 1e-5, (s, wr, dsplit)


@pytest.mark.parametrize("shape", [(8, 128, 10, 1, 256), (8, 16, 10, 1, 256),
                                   (8, 128, 9, 3, 64), (8, 16, 9, 3, 64)])
def test_flash_attention_is_bitwise_run_to_run(shape):
    """Every sum in a fixed order (no atomics): two calls on the same
    inputs give the same bits."""
    dev = _card()
    b, s, h, kvh, d = shape
    gen = torch.Generator().manual_seed(s + d)
    q = torch.randn(b, s, h, d, generator=gen).to(dev)
    k, v = (torch.randn(b, s, kvh, d, generator=gen).to(dev)
            for _ in range(2))
    assert torch.equal(tk.flash_attention_op(q, k, v, True),
                       tk.flash_attention_op(q, k, v, True))


def test_flash_attention_gradient_through_the_kernel():
    dev = _card()
    g = torch.Generator().manual_seed(0)
    q, k, v, w = (torch.randn(2, 19, 2, 64, generator=g).to(dev)
                  for _ in range(4))
    grads = []
    for fn in (lambda *a: tk.flash_attention_op(*a, True),
               lambda *a: tk.flash_attention_ref(*a, causal=True)):
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*args) * w).sum().backward()
        grads.append([a.grad for a in args])
    for got, want in zip(*grads):
        assert _rel(got, want) <= 1e-5


def test_new_ops_refuse_other_layouts_and_dtypes():
    dev = _card()
    x = torch.randn(4, 64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tk.rmsnorm_op(x.t(), torch.zeros(4, device=dev))
    with pytest.raises(TypeError, match="float32"):
        tk.rmsnorm_op(x.double(), torch.zeros(64, device=dev,
                                              dtype=torch.float64))
    a = torch.rand(2, 5, 8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tk.rglru_scan_op(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(TypeError, match="float32"):
        tk.rglru_scan_op(a.double(), a.double())
    q = torch.randn(1, 6, 2, 16, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tk.flash_attention_op(q.transpose(1, 2), q.transpose(1, 2),
                              q.transpose(1, 2))
    with pytest.raises(TypeError, match="float32"):
        tk.flash_attention_op(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dim"):
        big = torch.randn(1, 2, 1, 288, device=dev)
        tk.flash_attention_op(big, big, big)


def test_tiny_recurrentgemma_on_the_card_matches_the_cpu(tmp_path):
    dev = _card()
    from repro_torch import runtime
    from repro_torch.compress import main
    out = str(tmp_path / "rg.npz")
    main(["--arch", "recurrentgemma-2b", "--method", "depth",
          "--budget-ratio", "0.9", "--seq", "16", "--out", out])
    art = runtime.load(out)
    toks = torch.randint(0, 64, (2, 12),
                         generator=torch.Generator().manual_seed(0))
    tk.reset_launch_counts()
    y = art.apply({"tokens": toks})
    counts = tk.launch_counts()
    assert all(counts[k] > 0 for k in ("rmsnorm", "rglru_scan",
                                       "merged_ffn"))
    cpu = runtime.load(out, device="cpu")
    y_cpu = cpu.apply({"tokens": toks})
    assert _rel(y, y_cpu) <= 1e-4
    cache, cache_cpu = art.init_cache(2, 12), cpu.init_cache(2, 12)
    for t in range(12):
        lg, cache = art.decode(cache, toks[:, t:t + 1].to(dev))
        lc, cache_cpu = cpu.decode(cache_cpu, toks[:, t:t + 1])
        assert _rel(lg, lc) <= 1e-4


# ---------------------------------------------------------------------------
# Serving on captured CUDA graphs (runtime/serving.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_arts(tmp_path_factory):
    """Depth-compressed reduced SmolLM-135M and RecurrentGemma-2B
    artifacts (merged FFNs; the latter with an 8-token local window)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.compress import main
    out = {}
    for arch in ("smollm-135m", "recurrentgemma-2b"):
        path = str(tmp_path_factory.mktemp("serve") / f"{arch}.npz")
        main(["--arch", arch, "--method", "depth", "--budget-ratio", "0.9",
              "--seq", "16", "--out", path])
        out[arch] = path
    return out


def _served(path):
    from repro_torch import runtime
    art = runtime.load(path)
    return art, (lambda c, t: art.decode(c, t)), art.init_cache


def test_captured_serve_loop_matches_pertoken(tiny_arts):
    """The captured loop against the eager per-token loop on the card:
    equal tokens, last prefill logits within 1e-5 of the largest; the
    capture counted one step's launches."""
    from repro_torch.runtime import serving
    dev = _card()
    art, step, mk = _served(tiny_arts["smollm-135m"])
    B, P, N = 4, 7, 9
    prompt = serving.random_prompts(1, B, P, 64, device=dev)
    tk.reset_launch_counts()
    _, _, lg, seqs = serving.serve_loop(step, lambda: mk(B, P + N), prompt, N)
    counted = tk.launch_counts()
    _, _, lg_pt, seqs_pt = serving.serve_loop_pertoken(
        step, lambda: mk(B, P + N), prompt, N)
    assert torch.equal(seqs.cpu(), seqs_pt.cpu())
    assert _rel(lg, lg_pt) <= 1e-5
    # warm-up and capture each call the wrappers once; replays do not
    assert counted["merged_ffn"] > 0 and counted["rmsnorm"] > 0
    run = serving._StepGraph(step, mk(B, P + N), B, P + N - 1)
    run.prepare(prompt, torch.full((B,), P))
    assert run.launches["merged_ffn"] * 2 == counted["merged_ffn"]


def test_two_runs_on_one_capture_agree(tiny_arts):
    """One capture, reset in place between runs: A, B, A give A twice."""
    from repro_torch.runtime import serving
    dev = _card()
    art, step, mk = _served(tiny_arts["recurrentgemma-2b"])
    B, P, N = 3, 6, 10                      # 15 steps past the 8-token ring
    a = serving.random_prompts(2, B, P, 64, device=dev)
    b = serving.random_prompts(3, B, P, 64, device=dev)
    lengths = torch.full((B,), P)
    run = serving._StepGraph(step, mk(B, P + N), B, P + N - 1)
    run.prepare(a, lengths)
    outs = []
    for prompt in (a, b, a):
        run.reset(prompt, lengths)
        run.advance(P + N - 1)
        outs.append(run.samples.clone())
    assert torch.equal(outs[0], outs[2]) and not torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-2b"])
def test_serve_requests_match_single_prompt_serving(tiny_arts, arch):
    from repro_torch.runtime import serving
    _card()
    art, step, mk = _served(tiny_arts[arch])
    prompts = serving.ragged_prompts(0, 5, 2, 9, 64)
    out = serving.serve_requests(step, mk, prompts, tokens=6, slots=2)
    assert out.report.completed == [0, 1, 2, 3, 4] and out.report.rounds == 3
    for i, p in enumerate(prompts):
        p = p.long().to(art.device)[None, :]
        _, _, _, solo = serving.serve_loop(step, lambda: mk(1, p.shape[1] + 6),
                                           p, 6, warm=False)
        assert torch.equal(out[0][i], solo[0].cpu())


def test_a_host_read_makes_the_capture_raise(tiny_arts):
    """A step that reads a value on the host cannot be captured: the
    serve call raises and returns nothing, with no eager retry (the step
    ran once eagerly for the warm-up and once under capture)."""
    from repro_torch.runtime import serving
    dev = _card()
    art, step, mk = _served(tiny_arts["smollm-135m"])
    calls = []

    def reads_host(cache, tokens):
        calls.append(1)
        logits, cache = step(cache, tokens)
        if float(logits.abs().max()) < 0:          # .item() on the host
            raise AssertionError
        return logits, cache
    prompt = serving.random_prompts(4, 2, 4, 64, device=dev)
    with pytest.raises(RuntimeError):
        serving.serve_loop(reads_host, lambda: mk(2, 8), prompt, 4)
    assert len(calls) == 2
    torch.cuda.synchronize()
    # the card serves on after the failed capture
    _, _, _, seqs = serving.serve_loop(step, lambda: mk(2, 8), prompt, 4)
    assert seqs.shape == (2, 4)


# ---------------------------------------------------------------------------
# The continuous engine on captured CUDA graphs (runtime/serving.py)
# ---------------------------------------------------------------------------

def _solo_tokens(step, mk, prompt, n, dev):
    from repro_torch.runtime import serving
    p = torch.as_tensor(prompt).long().to(dev)[None, :]
    return serving.serve_loop(step, lambda: mk(1, p.shape[1] + n), p, n,
                              warm=False)[3][0].cpu()


@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-2b"])
def test_continuous_engine_matches_single_prompt_serving(tiny_arts, arch,
                                                          monkeypatch):
    """Ragged requests at staggered arrivals through 2 slots: the chunk
    step is captured once per engine and replayed ``chunk`` times a
    chunk, and every request's tokens equal its prompt served alone at
    batch 1."""
    from repro_torch.runtime import serving
    from repro_torch.testing import faults
    dev = _card()
    art, step, mk = _served(tiny_arts[arch])
    graphs, replays = [], []
    capture = serving._capture
    monkeypatch.setattr(serving, "_capture", lambda *a: graphs.append(1)
                        or capture(*a))
    replay = torch.cuda.CUDAGraph.replay
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay",
                        lambda g: replays.append(1) or replay(g))
    chunks = []
    run = serving._ChunkGraph.run
    monkeypatch.setattr(serving._ChunkGraph, "run",
                        lambda g, ctl: chunks.append(1) or run(g, ctl))
    prompts = serving.ragged_prompts(0, 5, 2, 9, 64)
    out = serving.serve_continuous(step, mk, prompts, tokens=6, slots=2,
                                   chunk=4, arrivals=[0, 1, 1, 3, 6],
                                   clock=faults.TickClock())
    assert out.report.completed and out.report.ok
    assert len(graphs) == 1 and len(replays) == 4 * len(chunks) > 0
    for i, p in enumerate(prompts):
        assert torch.equal(out[0][i], _solo_tokens(step, mk, p, 6, dev))


def test_idle_slot_far_past_its_cache_stays_in_range(tiny_arts):
    """Requests one at a time through 2 slots of a 10-position window:
    slot 1 idles through every chunk (its plain KV caches clamp at the
    last entry) until its position is over 10x the window; no device
    fault, and every request is token-exact."""
    from repro_torch.runtime import serving
    from repro_torch.testing import faults
    dev = _card()
    art, step, mk = _served(tiny_arts["smollm-135m"])
    eng = serving.ContinuousEngine(step, mk, slots=2, max_seq=10, chunk=4,
                                   clock=faults.TickClock())
    prompts = serving.ragged_prompts(5, 12, 4, 4, 64)
    for r, p in enumerate(prompts):
        eng.submit(p, tokens=6, arrival=20.0 * r, rid=r)
    report = eng.run()
    torch.cuda.synchronize()
    assert sorted(report.completed) == list(range(12))
    pos = [st["pos"].tolist() for st in eng.state if "pos" in st]
    assert pos and all(p[1] > 10 * 10 for p in pos)
    for r, p in enumerate(prompts):
        assert eng.requests[r].tokens == _solo_tokens(step, mk, p, 6,
                                                      dev).tolist()


def test_a_host_read_makes_the_engine_capture_raise(tiny_arts):
    """A step that reads the host cannot be captured: building the engine
    raises, with no eager retry (one warm-up call, one under capture)."""
    from repro_torch.runtime import serving
    _card()
    art, step, mk = _served(tiny_arts["smollm-135m"])
    calls = []

    def reads_host(cache, tokens):
        calls.append(1)
        logits, cache = step(cache, tokens)
        if float(logits.abs().max()) < 0:          # .item() on the host
            raise AssertionError
        return logits, cache
    with pytest.raises(RuntimeError):
        serving.ContinuousEngine(reads_host, mk, slots=2, max_seq=8)
    assert len(calls) == 2
    torch.cuda.synchronize()


def test_serve_fault_smoke_on_the_card():
    from repro_torch.testing import faults
    _card()
    out = faults.serve_fault_smoke()
    assert out["survivors_bit_identical"] and out["aborted"] == {1: 2}
    assert out["device"].startswith("cuda")


def _grad_cases():
    """``name -> (kernel counter, op, plain, shapes)`` of the gradient
    checks: every fp32 op and the three quantized bodies (w8a8), the
    differentiable inputs listed by shape (quantized weights fixed)."""
    from repro_torch.kernels import ops

    return {
        "merged_conv": ("merged_conv",
                        lambda x, w, b: tk.merged_conv_op(
                            x, w, b, stride=2, activation="relu6"),
                        lambda x, w, b: tk.apply_activation(
                            tk.merged_conv_ref(x, w, b, stride=2), "relu6"),
                        [(2, 11, 11, 8), (3, 3, 8, 24), (24,)]),
        "depthwise_conv": ("depthwise_conv",
                           lambda x, w, b: tk.depthwise_conv_op(
                               x, w, b, stride=1),
                           lambda x, w, b: tk.depthwise_conv_ref(
                               x, w, b, stride=1),
                           [(2, 10, 10, 16), (3, 3, 1, 16), (16,)]),
        "merged_ffn": ("merged_ffn", tk.merged_ffn_op, tk.merged_ffn_ref,
                       [(37, 96), (96, 160), (160, 96)]),
        "rmsnorm": ("rmsnorm", lambda x, g: tk.rmsnorm_op(x, g),
                    lambda x, g: tk.rmsnorm_ref(x, g), [(2, 9, 576), (576,)]),
        "rglru_scan": ("rglru_scan", tk.rglru_scan_op, tk.rglru_scan_ref,
                       [(2, 33, 64), (2, 33, 64)]),
        "flash_attention": ("flash_attention",
                            lambda q, k, v: tk.flash_attention_op(
                                q, k, v, True),
                            lambda q, k, v: ops._attention_plain(
                                q, k, v, True),
                            [(2, 19, 4, 64), (2, 19, 2, 64),
                             (2, 19, 2, 64)]),
        "merged_conv_q": ("merged_conv_q", None, None,
                          [(2, 9, 9, 8), (24,), (24,)]),
        "depthwise_conv_q": ("depthwise_conv_q", None, None,
                             [(2, 9, 9, 16), (16,), (16,)]),
        "merged_ffn_q": ("merged_ffn_q", None, None,
                         [(8, 96), (96,), (96,)]),
    }


def _qweights(shape):
    from repro_torch.kernels import quant
    g = torch.Generator().manual_seed(3)
    axis = 3 if len(shape) == 4 else 1
    w = torch.randn(*shape, generator=g) / np.sqrt(np.prod(shape[:-1]))
    return quant.quantize_weight(w, "int8", axis=axis)


@pytest.mark.parametrize("name", sorted(_grad_cases()))
def test_op_gradient_through_the_kernel(name):
    """The gradient of every input through the kernel op equals the plain
    version's autograd (``*_qref`` for the quantized bodies) within 1e-5
    of its largest element; one kernel launch, in the forward.  The scan's
    gradient is its backward kernel's: bitwise, one launch of it."""
    dev = _card()
    kernel, op, plain, shapes = _grad_cases()[name]
    g = torch.Generator().manual_seed(len(name))
    args = [torch.randn(*s, generator=g).to(dev) for s in shapes]
    if name == "rglru_scan":
        args[0] = torch.sigmoid(args[0])
    if name.endswith("_q"):
        base = name[:-2]
        wshape = {"merged_conv": (1, 1, 8, 24),
                  "depthwise_conv": (3, 3, 1, 16),
                  "merged_ffn": (96, 96)}[base]
        wq, ws = (t.to(dev) for t in _qweights(wshape))
        args[2] = ws.clone()
        if base == "merged_ffn":
            vq, vs = (t.to(dev) for t in _qweights((96, 96)))
            args[1:] = [ws.clone(), vs.clone()]
            op = lambda x, us, vs: tk.merged_ffn_op(           # noqa: E731
                x, wq, vq, u_scale=us, v_scale=vs, act_quant="w8a8")
            plain = lambda x, us, vs: tk.merged_ffn_qref(      # noqa: E731
                x, wq, vq, us, vs, act_quant="w8a8")
        else:
            fop = tk.merged_conv_op if base == "merged_conv" else \
                tk.depthwise_conv_op
            fref = tk.merged_conv_qref if base == "merged_conv" else \
                tk.depthwise_conv_qref
            op = lambda x, b, ws: fop(x, wq, b, w_scale=ws,    # noqa: E731
                                      act_quant="w8a8")
            plain = lambda x, b, ws: fref(x, wq, b, ws,        # noqa: E731
                                          act_quant="w8a8")
    before = tk.launch_counts()[kernel]
    bwd_before = tk.launch_counts()["rglru_scan_bwd"]
    sides = []
    for fn in (op, plain):
        leaves = [a.clone().requires_grad_() for a in args]
        y = fn(*leaves)
        w = torch.randn(y.shape, generator=torch.Generator().manual_seed(9))
        sides.append((y, torch.autograd.grad(y, leaves, w.to(dev))))
    (y, got), (_, want) = sides
    assert y.grad_fn is not None
    assert tk.launch_counts()[kernel] - before == 1
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-5
    if name == "rglru_scan":        # its backward kernel, bitwise
        assert tk.launch_counts()["rglru_scan_bwd"] - bwd_before == 1
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _eq4_host(norm=None):
    from repro_torch.core import ImportanceSpec, neg_loss_perf, xent_loss
    from repro_torch.models import cnn, cnn_host, zoo
    dev = _card()
    net = zoo.tiny_resnet(num_classes=4, in_hw=8, width=4, blocks=(2,),
                          norm=norm)
    params = cnn.init_params(net, torch.Generator().manual_seed(0),
                             device=dev)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, 8, 8, 3, generator=g).to(dev)
    y = torch.randint(0, 4, (8,), generator=g).to(dev)
    spec = ImportanceSpec(xent_loss, neg_loss_perf(xent_loss), [(x, y)],
                          [(x, y)], steps=2, lr=1e-3)
    host = cnn_host.CNNHost(net, params, batch=4, device=dev)
    return host, spec


def test_eq4_batched_engine_matches_sequential_on_the_card():
    """The vmapped span batches (grouped convolutions on the card) against
    one scalar fine-tune per probe: the reference's rtol 1e-6, atol 1e-7."""
    from repro_torch.core import enumerate_probes, measure_importances
    from repro_torch.core.probe_engine import EngineStats
    host, spec = _eq4_host()
    base = spec.perf_fn(host.replaced_apply(None)[0], host.params,
                        spec.eval_batches)
    segs = [p[5] for p in enumerate_probes(host) if not p[5].original]
    stats = EngineStats()
    bat = measure_importances(host, segs, spec, base, stats=stats,
                              force_batching=True)
    seq = measure_importances(host, segs, spec, base, engine="sequential")
    assert stats.num_importance_batches > 0
    np.testing.assert_allclose(bat, seq, rtol=1e-6, atol=1e-7)


def test_eq4_finetune_is_bitwise_under_deterministic_cudnn():
    """Two runs of one Eq. 4 fine-tune (BN leaves included) give the same
    tuned leaves and importance bit for bit under deterministic cuDNN."""
    from repro_torch.core import measure_importance, one_segment_plan
    from repro_torch.core.importance import _adam_finetune
    from repro_torch.core.tables import enumerate_probes
    from repro_torch.device import deterministic_cudnn
    host, spec = _eq4_host(norm="bn")
    seg = next(p[5] for p in enumerate_probes(host) if not p[5].original)
    fn, p = host.replaced_apply(one_segment_plan(host, seg))
    with deterministic_cudnn():
        runs = [_adam_finetune(fn, p, spec) for _ in range(2)]
        imps = [measure_importance(fn, p, spec, 0.0) for _ in range(2)]
    from torch.utils import _pytree as pytree
    for a, b in zip(*(pytree.tree_leaves(r) for r in runs)):
        assert torch.equal(a, b)
    assert imps[0] == imps[1]


# -- the crash-safe table build -----------------------------------------------

def test_kill_and_resume_with_the_wallclock_oracle(tmp_path):
    """A child process times ``tiny_resnet``'s probes on the card and dies
    at its 4th journaled bucket; the resume replays the journal: every
    journaled signature's seconds are bitwise in the resumed tables and
    in the ``T_orig`` terms priced after them, and a third build is a
    bitwise cache hit (``kill_resume_smoke`` raises otherwise)."""
    _card()
    from repro_torch.testing import faults
    out = faults.kill_resume_smoke(kill_at_bucket=4, device="cuda",
                                   oracle="wallclock", work_dir=str(tmp_path))
    assert out["journal_hits_on_resume"] >= 3
    assert out["entries_checked_against_journal"] > 0
    assert out["signatures_timed_on_resume"] > 0   # the rest were timed


def test_table_cache_hit_on_the_card_times_nothing(tmp_path):
    """A second compress with a fresh wall-clock oracle reads the cached
    tables and their timings: no signature is timed, ``T_orig`` included,
    and the plan and ``T_orig`` are the first run's, bitwise."""
    dev = _card()
    from repro_torch.core import WallClockOracle, compress
    from repro_torch.models import cnn, cnn_host, zoo
    net = zoo.tiny_resnet(num_classes=4, in_hw=8, width=4, blocks=(2,))
    params = cnn.init_params(net, torch.Generator().manual_seed(0),
                             device=dev)
    host = cnn_host.CNNHost(net, params, batch=4, device=dev)
    first = compress(host, budget_ratio=0.8, latency_oracle=WallClockOracle(),
                     cache_dir=str(tmp_path))
    ora = WallClockOracle()
    hit = compress(host, budget_ratio=0.8, latency_oracle=ora,
                   cache_dir=str(tmp_path))
    assert hit.tables.stats.cache_hit and ora.num_timed == 0
    assert hit.plan == first.plan
    assert hit.original_latency == first.original_latency
    assert hit.tables.entries == first.tables.entries


def test_distributed_build_with_a_killed_worker_on_the_card(tmp_path):
    """Two workers time ``tiny_resnet``'s probes on the card, one after the
    other; worker 0 dies at its 2nd item holding the lease (exit 17) and
    worker 1 steals it.  No probe fails (strict policy), the workers
    launched merged_conv, and the merged tables are bitwise a fresh
    coordinator's resume from the merged records, which times nothing."""
    _card()
    from repro_torch.core import (ProbeConfig, WallClockOracle, build_tables,
                                  dist_build_tables, table_cache)
    from repro_torch.core.dist_build import merge_shards
    from repro_torch.testing import faults, hosts
    host, params = hosts.tiny_resnet_host(device="cuda")
    wd = str(tmp_path / "wd")
    strict = ProbeConfig(retries=0, quarantine=False)
    with faults.inject(faults.Fault("dist.item", "kill-worker", nth=2,
                                    widx=0)):
        tables, rep = dist_build_tables(
            host, params=params, cache_dir=str(tmp_path / "c"), workers=2,
            host_spec={"factory": "repro_torch.testing.hosts:tiny_resnet_host",
                       "kwargs": {"device": "cuda"}},
            latency_oracle=WallClockOracle(), probe_config=strict,
            lease_s=0.5, serial_spawn=True, work_dir=wd, keep_work_dir=True)
    assert rep.dead_workers == [0] and rep.exit_codes == {0: 17, 1: 0}
    assert rep.reassigned and rep.coordinator_items == 0
    assert sum(rep.completed_by.values()) == rep.items
    assert rep.worker_lines[1]["launches"]["merged_conv"] > 0
    records, _, corrupt = merge_shards(wd, ["w0", "w1", "coord"])
    assert corrupt == 0 and all(v is not None for v, _, _ in records.values())
    key = table_cache.cache_key(host, WallClockOracle(), "layermerge",
                                "magnitude")
    fresh = str(tmp_path / "fresh")
    table_cache.BuildJournal(fresh, key).put_many(
        [(k, v, p) for k, (v, p, _) in records.items()])
    ora = WallClockOracle()
    again = build_tables(host, params=params, latency_oracle=ora,
                         cache_dir=fresh, probe_config=strict)
    assert ora.num_timed == 0
    assert again.entries == tables.entries
    assert again.num_pruned == tables.num_pruned


# ---------------------------------------------------------------------------
# The other transformer families: MoE, xLSTM, M-RoPE
# ---------------------------------------------------------------------------

def _capture_once(fn):
    """``fn`` warmed up on a side stream, then captured in a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def test_moe_layer_captured_replays_bitwise():
    """A granite-shaped MoE FFN (32 experts, top-8, capacity 1.25: pairs
    drop) on 8 decode rows: a captured replay equals the eager call
    bitwise, and the port's routing reads nothing on the host."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    dev = _card()
    cfg = get_config("granite-moe-1b-a400m")
    gen = torch.Generator().manual_seed(0)
    p = {k: v.to(dev) for k, v in
         moe.init_moe(cfg, gen, torch.float32)[0].items()}
    x = torch.randn(8, 1, cfg.d_model, generator=gen).to(dev)
    out = torch.empty_like(x)

    def call():
        out.copy_(moe.moe_ffn(p, x, cfg, capacity_factor=1.25))
    graph = _capture_once(call)
    call()
    eager = out.clone()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    ref = moe.moe_ffn({k: v.cpu() for k, v in p.items()}, x.cpu(), cfg,
                      capacity_factor=1.25)
    assert _rel(eager, ref) <= 1e-5


def test_xlstm_decode_step_captured_replays_bitwise():
    """One decode step of a 2-layer xLSTM stack (mLSTM, sLSTM; d 768, 4
    heads), captured and replayed from the fresh state, against eager
    steps from the same state: bitwise at every step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    dev = _card()
    cfg = dataclasses.replace(get_config("xlstm-125m"), num_layers=2,
                              temporal_pattern=("mlstm", "slstm"),
                              vocab_size=512, dtype="float32")
    params, _ = T.init_model(cfg, device=dev)
    toks = torch.randint(0, 512, (4, 6),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    eager_cache = T.init_cache(cfg, 4, 6, device=dev)
    eager = [T.decode_step(cfg, params, eager_cache,
                           {"tokens": toks[:, t:t + 1]})[0]
             for t in range(6)]
    cache = T.init_cache(cfg, 4, 6, device=dev)
    fresh = [{k: v.clone() for k, v in c.items()} for c in cache]
    feed = torch.zeros((4, 1), dtype=torch.long, device=dev)
    out = torch.empty_like(eager[0])

    def step():
        out.copy_(T.decode_step(cfg, params, cache, {"tokens": feed})[0])
    graph = _capture_once(step)
    for c, f in zip(cache, fresh):
        for k in c:
            c[k].copy_(f[k])
    for t in range(6):
        feed.copy_(toks[:, t:t + 1])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager[t]), t


@pytest.mark.parametrize("m,d", [(m, d) for m in (1024, 8)
                                 for d in (1024, 768, 3584)])
def test_rmsnorm_at_the_new_widths(m, d):
    dev = _card()
    g = torch.Generator().manual_seed(m + d)
    x, w = torch.randn(m, d, generator=g), torch.randn(d, generator=g) * 0.2
    y = tk.rmsnorm_op(x.to(dev), w.to(dev), eps=1e-6)
    yr = tk.rmsnorm_ref(x, w, 1e-6)
    assert _rel(y, yr) <= 1e-5


@pytest.mark.parametrize("shape", [(8, 128, 16, 8, 64), (8, 16, 16, 8, 64),
                                   (8, 128, 28, 4, 128), (8, 16, 28, 4, 128)])
def test_flash_attention_at_the_new_shapes(shape):
    from repro_torch.kernels import ops
    dev = _card()
    b, s, h, kvh, d = shape
    g = torch.Generator().manual_seed(s + h)
    q = torch.randn(b, s, h, d, generator=g)
    k, v = (torch.randn(b, s, kvh, d, generator=g) for _ in range(2))
    y = tk.flash_attention_op(q.to(dev), k.to(dev), v.to(dev), True)
    assert _rel(y, ops._attention_plain(q, k, v, True)) <= 1e-5


@pytest.mark.parametrize("m", [8, 1024])
def test_merged_ffn_at_d3584(m):
    """qwen2-vl's merged unit width (D = R = 3584), held as the wide
    cases are: within 1e-4 of each output's scale."""
    dev = _card()
    x, u, v = _ffn_factors(m, 3584, 3584, dev)
    _within_scale(tk.merged_ffn_op(x, u, v), tk.merged_ffn_ref(x, u, v),
                  x, x, u, v)


# ---------------------------------------------------------------------------
# LM training on the card
# ---------------------------------------------------------------------------

def _train_cfg(dtype="float32"):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("smollm-135m"), num_layers=2, d_model=64, num_heads=2,
        num_kv_heads=1, head_dim=32, d_ff=96, vocab_size=128, dtype=dtype,
        remat=False)


def _flat(tree):
    from repro_torch.tree import flatten_tree
    return {k: v.detach().cpu() for k, v in flatten_tree(tree).items()}


def test_train_step_on_the_card_matches_the_cpu():
    """One SmolLM-shaped train step (2 layers, d 64): the loss within 1e-5
    relative, every gradient leaf within 1e-4 · max |g| of the CPU port's,
    the updates within 1e-3 · lr + 1e-3 · |update| where |g| > 1e-6; the
    forward launches rmsnorm 5 and flash_attention 2 times, the backward
    neither (the plain versions' gradients)."""
    dev = _card()
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.step import (make_loss_fn, make_train_step,
                                        value_and_grad)
    from repro_torch.tree import tree_map
    cfg = _train_cfg()
    p_cpu, _ = T.init_model(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    p_dev = tree_map(lambda t: t.to(dev), p_cpu)
    nb = SyntheticTokens(cfg.vocab_size, 2, 64, seed=0).batch_at(0)
    b_cpu = {k: torch.from_numpy(v) for k, v in nb.items()}
    b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
    loss_fn = make_loss_fn(cfg)
    l_cpu, g_cpu = value_and_grad(loss_fn, p_cpu, b_cpu)
    tk.reset_launch_counts()
    l_dev, g_dev = value_and_grad(loss_fn, p_dev, b_dev)
    torch.cuda.synchronize()
    n = tk.launch_counts()
    assert (n["rmsnorm"], n["flash_attention"]) == (5, 2)
    assert float(l_dev) == pytest.approx(float(l_cpu), rel=1e-5)
    gc, gd = _flat(g_cpu), _flat(g_dev)
    for k, v in gc.items():
        assert float((gd[k] - v).abs().max()) <= \
            1e-4 * float(v.abs().max()) + 1e-12, k
    opt = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=4)
    step = make_train_step(cfg, opt)
    before = _flat(p_cpu)
    p_cpu, _, m_cpu = step(p_cpu, init_opt_state(p_cpu), b_cpu)
    p_dev, _, m_dev = step(p_dev, init_opt_state(p_dev), b_dev)
    after_c, after_d = _flat(p_cpu), _flat(p_dev)
    for k, g in gc.items():
        live = g.abs() > 1e-6
        du_c = (after_c[k] - before[k])[live]
        du_d = (after_d[k] - before[k])[live]
        assert bool(((du_d - du_c).abs() <= 1e-3 * opt.lr
                     + 1e-3 * du_c.abs()).all()), k


def test_bf16_train_step_on_the_card_matches_the_cpu():
    """A SmolLM-shaped bf16 config (2 layers, d 64): the loss within 1e-2
    relative and every gradient leaf within 5e-2 · max |g| of the CPU
    port's (both bf16, rounding in other orders), the forward through the
    bf16 bodies (rmsnorm 5, flash_attention 2 launches, the fp32 bodies
    none); one AdamW step keeps the params bf16 and the moments fp32."""
    dev = _card()
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.train.step import (make_loss_fn, make_train_step,
                                        value_and_grad)
    from repro_torch.tree import tree_leaves, tree_map
    cfg = _train_cfg("bfloat16")
    p_cpu, _ = T.init_model(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    p_dev = tree_map(lambda t: t.to(dev), p_cpu)
    nb = SyntheticTokens(cfg.vocab_size, 2, 64, seed=0).batch_at(0)
    b_cpu = {k: torch.from_numpy(v) for k, v in nb.items()}
    b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
    loss_fn = make_loss_fn(cfg)
    l_cpu, g_cpu = value_and_grad(loss_fn, p_cpu, b_cpu)
    tk.reset_launch_counts()
    l_dev, g_dev = value_and_grad(loss_fn, p_dev, b_dev)
    torch.cuda.synchronize()
    n = tk.launch_counts()
    assert (n["rmsnorm_bf16"], n["flash_attention_bf16"]) == (5, 2)
    assert (n["rmsnorm"], n["flash_attention"]) == (0, 0)
    assert float(l_dev) == pytest.approx(float(l_cpu), rel=1e-2)
    gc, gd = _flat(g_cpu), _flat(g_dev)
    for k, v in gc.items():
        assert gd[k].dtype == torch.bfloat16, k
        assert float((gd[k].float() - v.float()).abs().max()) <= \
            5e-2 * float(v.float().abs().max()) + 1e-12, k
    step = make_train_step(cfg, AdamWConfig(lr=1e-2, warmup_steps=0,
                                            total_steps=4))
    p_dev, state, _ = step(p_dev, init_opt_state(p_dev), b_dev)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(p_dev))
    assert all(t.dtype == torch.float32
               for t in tree_leaves([state["mu"], state["nu"]]))


def _bf16_within(y, yr, allowance: float = 0.0) -> bool:
    """Every element of y within one bf16 ulp (of the larger of the two)
    of yr, beyond an fp32 allowance: two fp32 sums that differ by δ round
    to bf16 values at most δ + 1 ulp apart (an attention output that
    cancels to near zero differs by more than its own ulp in fp32)."""
    y, yr = y.float().cpu(), yr.float().cpu()
    assert y.shape == yr.shape and bool(torch.isfinite(y).all())
    a = torch.maximum(y.abs(), yr.abs()).clamp_min(
        torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
    return bool(((y - yr).abs() <= ulp + allowance).all())


@pytest.mark.parametrize("m,d,g32", [(8, 2560, False), (37, 2561, True),
                                     (1024, 3072, False), (8192, 576, True),
                                     (5, 3584, False)])
def test_rmsnorm_bf16_matches_plain_version(m, d, g32):
    dev = _card()
    g = torch.Generator().manual_seed(m + d)
    x = (torch.randn(m, d, generator=g) * 3).to(dev).bfloat16()
    w = (torch.randn(d, generator=g) * 0.2).to(dev)
    w = w if g32 else w.bfloat16()
    before = tk.launch_counts()["rmsnorm_bf16"]
    y = tk.rmsnorm_op(x, w, eps=1e-6)
    assert tk.launch_counts()["rmsnorm_bf16"] == before + 1
    assert y.dtype == torch.bfloat16
    assert _bf16_within(y, tk.rmsnorm_ref(x, w, 1e-6))
    assert torch.equal(y, tk.rmsnorm_op(x, w, eps=1e-6))
    assert torch.equal(y, tk.rmsnorm_op(x.float(), w.float(),
                                        eps=1e-6).bfloat16())


@pytest.mark.parametrize("shape,kvh,causal", [
    ((8, 128, 16, 256), 16, True), ((8, 16, 28, 128), 4, True),
    ((8, 128, 10, 256), 1, True), ((2, 37, 9, 64), 3, False),
    ((2, 7, 4, 36), 2, True), ((1, 130, 2, 100), 1, False),
    ((8, 1024, 9, 64), 3, True)])
def test_flash_attention_bf16_matches_plain_version(shape, kvh, causal):
    """The configs' head dims (64, 128, 256) and ragged ones (36: element
    copies, not 16-byte ones; 100), grouped and multi-query heads."""
    dev = _card()
    b, s, h, d = shape
    g = torch.Generator().manual_seed(s + d + h)
    q = torch.randn(b, s, h, d, generator=g).to(dev).bfloat16()
    k, v = (torch.randn(b, s, kvh, d, generator=g).to(dev).bfloat16()
            for _ in range(2))
    before = tk.launch_counts()["flash_attention_bf16"]
    y = tk.flash_attention_op(q, k, v, causal)
    assert tk.launch_counts()["flash_attention_bf16"] == before + 1
    assert y.dtype == torch.bfloat16
    ke, ve = (t.repeat_interleave(h // kvh, dim=2) for t in (k, v))
    yr = tk.flash_attention_ref(q, ke, ve, causal)
    # the fp32 body's own tolerance (1e-5 of the largest output)
    allowance = 1e-5 * float(yr.float().abs().max())
    assert _bf16_within(y, yr, allowance)
    assert torch.equal(y, tk.flash_attention_op(q, k, v, causal))
    assert _bf16_within(y, tk.flash_attention_op(
        q.float(), k.float(), v.float(), causal).bfloat16(), allowance)


def test_bf16_ops_refuse_mixed_dtypes():
    dev = _card()
    q = torch.randn(1, 6, 2, 64, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        tk.flash_attention_op(q.bfloat16(), q, q.bfloat16())
    x = torch.randn(4, 64, device=dev)
    with pytest.raises(TypeError, match="float32"):
        tk.rmsnorm_op(x, torch.zeros(64, device=dev, dtype=torch.bfloat16))


@pytest.mark.parametrize("kind", ["rmsnorm", "flash_attention",
                                  "merged_ffn"])
def test_kernels_at_the_training_shapes(kind):
    """SmolLM-135M at batch 8 x seq 1024: rmsnorm (8192, 576),
    flash_attention (8, 1024, 9, 64) over 3 kv heads, merged_ffn (8192,
    576) at rank 576."""
    dev = _card()
    g = torch.Generator().manual_seed(24)
    if kind == "rmsnorm":
        x = (torch.randn(8192, 576, generator=g) * 3).to(dev)
        w = (torch.randn(576, generator=g) * 0.2).to(dev)
        assert _rel(tk.rmsnorm_op(x, w, eps=1e-6),
                    tk.rmsnorm_ref(x, w, 1e-6)) <= 1e-5
    elif kind == "flash_attention":
        q = torch.randn(8, 1024, 9, 64, generator=g).to(dev)
        k, v = (torch.randn(8, 1024, 3, 64, generator=g).to(dev)
                for _ in range(2))
        ke, ve = (t.repeat_interleave(3, dim=2) for t in (k, v))
        assert _rel(tk.flash_attention_op(q, k, v, True),
                    tk.flash_attention_ref(q, ke, ve, True)) <= 1e-5
    else:
        x = torch.randn(8192, 576, generator=g).to(dev)
        u = (torch.randn(576, 576, generator=g) / 24).to(dev)
        v = (torch.randn(576, 576, generator=g) / 24).to(dev)
        y, yr = tk.merged_ffn_op(x, u, v), tk.merged_ffn_ref(x, u, v)
        scale = tk.merged_ffn_ref(x.abs(), u.abs(), v.abs())
        assert bool(((y - yr).abs() <= 1e-4 * scale + 1e-6).all())
