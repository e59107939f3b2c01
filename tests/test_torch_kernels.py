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


# -- the norm, the scan and attention -----------------------------------------

def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-30)


@pytest.mark.parametrize("shape", [(3, 5, 37), (130, 64), (1, 2561),
                                   (2, 1, 576)])
def test_rmsnorm_matches_pallas(shape):
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    g = (0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    y = tk.rmsnorm_op(_t(x), _t(g), eps=1e-6)
    yj = jk.rmsnorm_op(_j(x), _j(g), eps=1e-6, interpret=True)
    assert _rel(y.numpy(), yj) <= 1e-6
    assert _rel(tk.rmsnorm_ref(_t(x), _t(g)).numpy(),
                jk.ref.rmsnorm_ref(_j(x), _j(g))) <= 1e-6


@pytest.mark.parametrize("b,s,c", [(2, 7, 37), (1, 300, 130), (3, 1, 5)])
def test_rglru_scan_matches_pallas(b, s, c):
    rng = np.random.default_rng(s + c)
    a = rng.uniform(0.5, 1.0, (b, s, c)).astype(np.float32)
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    h = tk.rglru_scan_op(_t(a), _t(x))
    hj = jk.rglru_scan_op(_j(a), _j(x), interpret=True)
    assert _rel(h.numpy(), hj) <= 1e-6
    # the plain version with h0 is the JAX oracle's
    h0 = rng.standard_normal((b, c)).astype(np.float32)
    assert _rel(tk.rglru_scan_ref(_t(a), _t(x), _t(h0)).numpy(),
                jk.ref.rglru_scan_ref(_j(a), _j(x), _j(h0))) <= 1e-6


ATTN_SHAPES = [(2, 7, 3, 16), (1, 37, 2, 8), (2, 1, 1, 32), (1, 16, 2, 64)]


@pytest.mark.parametrize("shape,causal", itertools.product(ATTN_SHAPES,
                                                           (True, False)))
def test_flash_attention_matches_pallas(shape, causal):
    rng = np.random.default_rng(sum(shape) + causal)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    y = tk.flash_attention_op(_t(q), _t(k), _t(v), causal)
    yj = jk.flash_attention_op(_j(q), _j(k), _j(v), causal, True)
    assert _rel(y.numpy(), yj) <= 1e-6


def test_flash_attention_grouped_heads_equal_expanded():
    """k and v with KVH < H heads: the op equals the plain version on k and
    v expanded to H heads (query head h reads kv head h // (H / KVH)),
    which is the JAX op on the expanded heads."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 9, 6, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
            for _ in range(2))
    y = tk.flash_attention_op(_t(q), _t(k), _t(v), True)
    ke, ve = np.repeat(k, 3, axis=2), np.repeat(v, 3, axis=2)
    yj = jk.flash_attention_op(_j(q), _j(ke), _j(ve), True, True)
    assert _rel(y.numpy(), yj) <= 1e-6


@pytest.mark.parametrize("causal", (True, False))
def test_flash_attention_gradient_matches_jax(causal):
    import jax
    rng = np.random.default_rng(11)
    q, k, v, w = (rng.standard_normal((2, 11, 2, 8)).astype(np.float32)
                  for _ in range(4))
    tq, tk_, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (tk.flash_attention_op(tq, tk_, tv, causal) * _t(w)).sum().backward()

    def loss(q, k, v):
        return (jk.flash_attention_op(q, k, v, causal, True) * _j(w)).sum()
    grads = jax.grad(loss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    for got, want in zip((tq.grad, tk_.grad, tv.grad), grads):
        assert _rel(got.numpy(), want) <= 1e-5


def test_the_new_ops_count_no_launch_on_the_cpu():
    before = tk.launch_counts()
    tk.rmsnorm_op(torch.ones(2, 4), torch.zeros(4))
    tk.rglru_scan_op(torch.ones(1, 2, 3), torch.ones(1, 2, 3))
    tk.flash_attention_op(torch.ones(1, 2, 1, 4), torch.ones(1, 2, 1, 4),
                          torch.ones(1, 2, 1, 4))
    assert tk.launch_counts() == before
    assert {"rmsnorm", "rglru_scan", "flash_attention"} <= set(before)
