"""The port's kernel ops against the JAX package's.

On the CPU the port's ops run their plain PyTorch versions; the JAX ops run
their Pallas kernels in interpret mode (``force_backend("pallas")``,
``interpret=True``), as the JAX package's own tests do.  Tolerance
``rtol = atol = 2e-5``: fp32 sums in different orders.  The tile and
traffic arithmetic the cost model prices with must be exactly equal.
The CUDA kernels themselves are held against the plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as jk
from repro.kernels import depthwise_conv as jdw
from repro.kernels import merged_conv as jmc
from repro.kernels import ops as jops
from repro_torch import kernels as tk
from repro_torch.kernels import depthwise_conv as tdw
from repro_torch.kernels import merged_conv as tmc

TOL = dict(rtol=2e-5, atol=2e-5)
ACTS = (None, "relu", "relu6", "silu")


def _data(seed, xshape, wshape, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xshape).astype(np.float32)
    fan = int(np.prod(wshape[:3]))
    w = (rng.standard_normal(wshape) / np.sqrt(fan)).astype(np.float32)
    b = rng.standard_normal(wshape[3]).astype(np.float32) if bias else None
    return x, w, b


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("stride,k", itertools.product((1, 2, 3),
                                                       (1, 2, 3, 5)))
def test_merged_conv_matches_pallas(stride, k):
    n = stride * 4 + k
    act = ACTS[(stride + k) % 4]
    # ragged Ho/Wo, Cout not a multiple of 8, no bias on some cases
    x, w, b = _data(k * 10 + stride, (2, k + 2 * stride + 1,
                                      k + 3 * stride, 5), (k, k, 5, 11),
                    bias=n % 3 != 0)
    y = tk.merged_conv_op(_t(x), _t(w), _t(b), stride=stride, activation=act)
    with jk.force_backend("pallas"):
        yj = jk.merged_conv_op(_j(x), _j(w), _j(b), stride=stride,
                               activation=act, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)


@pytest.mark.parametrize("stride,k,case", [
    *itertools.product((1, 2, 3), (1, 3, 5), ("depthwise",)),
    (1, 3, "multiplier"), (2, 5, "multiplier"), (3, 2, "multiplier"),
    (1, 5, "grouped"), (2, 3, "grouped"), (3, 1, "grouped")])
def test_depthwise_conv_matches_pallas(stride, k, case):
    groups, cin_g, cout_g = {"depthwise": (13, 1, 1),
                             "multiplier": (6, 1, 3),
                             "grouped": (3, 4, 2)}[case]
    act = ACTS[(stride + k) % 4]
    x, w, b = _data(stride * 7 + k, (2, k + 2 * stride + 2, k + stride + 1,
                                     groups * cin_g),
                    (k, k, cin_g, groups * cout_g), bias=k != 3)
    y = tk.depthwise_conv_op(_t(x), _t(w), _t(b), stride=stride,
                             groups=groups, activation=act)
    with jk.force_backend("pallas"):
        yj = jk.depthwise_conv_op(_j(x), _j(w), _j(b), stride=stride,
                                  groups=groups, activation=act,
                                  interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)


@pytest.mark.parametrize("mode,act_quant", [("int8", "none"),
                                            ("int8", "w8a8")])
def test_quantized_plain_versions_match(mode, act_quant):
    x, w, b = _data(3, (2, 9, 8, 6), (3, 3, 6, 10))
    wq, ws = tk.quant.quantize_weight(_t(w), mode, axis=3)
    jwq, jws = jk.quant.quantize_weight(_j(w), mode, axis=3)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    y = tk.merged_conv_op(_t(x), wq, _t(b), stride=2, w_scale=ws,
                          act_quant=act_quant)
    yj = jk.merged_conv_op(_j(x), jwq, _j(b), stride=2, w_scale=jws,
                           act_quant=act_quant)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    xd, wd, bd = _data(4, (2, 9, 8, 6), (3, 3, 1, 6))
    wq, ws = tk.quant.quantize_weight(_t(wd), mode, axis=3)
    jwq, jws = jk.quant.quantize_weight(_j(wd), mode, axis=3)
    y = tk.depthwise_conv_op(_t(xd), wq, _t(bd), w_scale=ws,
                             act_quant=act_quant)
    yj = jk.depthwise_conv_op(_j(xd), jwq, _j(bd), w_scale=jws,
                              act_quant=act_quant)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)


def test_quant_primitives_match():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 7)) * 3).astype(np.float32)
    for axis in (None, 0, 1):
        q, s = tk.quant.quantize_int8(_t(x), axis=axis)
        jq, js = jk.quant.quantize_int8(_j(x), axis=axis)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tk.quant.dequantize(q, s, axis).numpy(),
            np.asarray(jk.quant.dequantize(jq, js, axis)))
    for mode in ("int8", "w8a8", "fp8"):
        assert tk.quant.error_budget(mode, fan_in=9, x_absmax=2.0,
                                     w_absmax=0.5) == \
            jk.quant.error_budget(mode, fan_in=9, x_absmax=2.0, w_absmax=0.5)


def test_activations_match():
    x = np.linspace(-8, 8, 101, dtype=np.float32)
    for act in ACTS:
        np.testing.assert_allclose(
            tk.apply_activation(torch.from_numpy(x), act).numpy(),
            np.asarray(jk.apply_activation(jnp.asarray(x), act)), **TOL)


# -- tile and traffic arithmetic (exact) --------------------------------------

BUDGET = jmc._VMEM_BUDGET


def test_channel_tile_exact():
    for cout in range(1, 300, 7):
        for req in (None, 1, 8, 13, 64, 200):
            assert tk.channel_tile(cout, req) == jops.channel_tile(cout, req)


@pytest.mark.parametrize("budget", [BUDGET, 232_448])
def test_tiles_and_traffic_exact(budget):
    for h, cin, k, s, itemsize in itertools.product(
            (7, 16, 57, 230), (3, 32, 960), (1, 2, 3, 7, 11), (1, 2, 3),
            (2, 4)):
        if h < k:
            continue
        args = (h, h + 3, cin, k, k, s, itemsize)
        assert tmc.choose_tiles(*args, budget_bytes=budget) == \
            jmc.choose_tiles(*args, budget_bytes=budget)
        for groups in (1, cin):
            if budget == BUDGET:
                want = jmc.input_traffic_model(*args, groups=groups)
                got = tmc.input_traffic_model(*args, groups=groups,
                                              budget_bytes=budget)
                assert got == {k: want[k] for k in got}
                assert set(got) == {"dma_bytes", "relayout_bytes"}
        assert tmc.phase_extents(k, k + 1, s) == jmc.phase_extents(k, k + 1, s)
    for g, cin_g, cout_g, req in itertools.product(
            (1, 13, 96, 960), (1, 4), (1, 3), (None, 16)):
        assert tdw.choose_group_block(g, cin_g, cout_g, req) == \
            jdw.choose_group_block(g, cin_g, cout_g, req)
        for h, k, s in itertools.product((9, 56, 112), (1, 3, 5), (1, 2)):
            args = (h, h, cin_g, cout_g, k, k, s, 4)
            bg = jdw.choose_group_block(g, cin_g, cout_g, req)
            assert tdw.choose_tiles_grouped(
                *args, bgroups=bg, budget_bytes=budget) == \
                jdw.choose_tiles_grouped(*args, bgroups=bg,
                                         budget_bytes=budget)
