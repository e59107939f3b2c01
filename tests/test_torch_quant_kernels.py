"""The port's quantized kernel ops against the JAX package's quantized
Pallas kernels, on the CPU.

The port's ops run their plain versions (``*_qref``) on CPU tensors; the
JAX ops run the quantized bodies of their Pallas kernels in interpret mode
(``force_backend("pallas")``, ``interpret=True``), as the JAX package's own
tests do — on the same integer codes and scales, quantized once in numpy's
hands.  Tolerance ``rtol = atol = 2e-4``: the dequantized-math tolerance
of the JAX package's own quantized kernel tests (fp32 sums in other
orders, the scale applied after the sum on one side and to each weight on
the other).  The CUDA variants are held against the same plain versions
on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as jk
from repro_torch import kernels as tk
from repro_torch.kernels import depthwise_conv as tdw
from repro_torch.kernels import merged_conv as tmc
from repro_torch.kernels import merged_ffn as tmf

QTOL = dict(rtol=2e-4, atol=2e-4)
#: mode -> (weight quantization, the op's act_quant)
QMODES = {"int8": ("int8", "none"), "w8a8": ("int8", "w8a8"),
          "fp8": ("fp8", "none")}


def _weights(w, mode, axis):
    """The same narrow weight and scale for both packages: quantized by the
    port, handed to JAX as numpy (fp8 through ml_dtypes' e4m3)."""
    wq, ws = tk.quant.quantize_weight(torch.from_numpy(w), mode, axis=axis)
    if wq.dtype == torch.float8_e4m3fn:
        jwq = jnp.asarray(wq.float().numpy()).astype(jnp.float8_e4m3fn)
    else:
        jwq = jnp.asarray(wq.numpy())
    return wq, ws, jwq, jnp.asarray(ws.numpy())


@pytest.mark.parametrize("mode,stride,k", [("int8", 2, 3), ("w8a8", 1, 3),
                                           ("fp8", 3, 1)])
def test_quantized_merged_conv_matches_pallas(mode, stride, k):
    wmode, aq = QMODES[mode]
    rng = np.random.default_rng(stride * 10 + k)
    x = rng.standard_normal((2, k + 2 * stride + 1, k + 3 * stride, 5)
                            ).astype(np.float32)
    w = (rng.standard_normal((k, k, 5, 11)) / np.sqrt(5 * k * k)
         ).astype(np.float32)
    b = rng.standard_normal(11).astype(np.float32)
    wq, ws, jwq, jws = _weights(w, wmode, 3)
    y = tk.merged_conv_op(torch.from_numpy(x), wq, torch.from_numpy(b),
                          stride=stride, w_scale=ws, act_quant=aq,
                          activation="relu6")
    with jk.force_backend("pallas"):
        yj = jk.merged_conv_op(jnp.asarray(x), jwq, jnp.asarray(b),
                               stride=stride, w_scale=jws, act_quant=aq,
                               activation="relu6", interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **QTOL)


@pytest.mark.parametrize("mode,case", [("int8", "depthwise"),
                                       ("w8a8", "multiplier"),
                                       ("fp8", "grouped")])
def test_quantized_depthwise_conv_matches_pallas(mode, case):
    wmode, aq = QMODES[mode]
    groups, cin_g, cout_g = {"depthwise": (13, 1, 1),
                             "multiplier": (6, 1, 3),
                             "grouped": (3, 4, 2)}[case]
    rng = np.random.default_rng(groups)
    x = rng.standard_normal((2, 9, 8, groups * cin_g)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin_g, groups * cout_g)) / 3
         ).astype(np.float32)
    wq, ws, jwq, jws = _weights(w, wmode, 3)
    y = tk.depthwise_conv_op(torch.from_numpy(x), wq, None, stride=2,
                             groups=groups, w_scale=ws, act_quant=aq,
                             activation="silu")
    with jk.force_backend("pallas"):
        yj = jk.depthwise_conv_op(jnp.asarray(x), jwq, None, stride=2,
                                  groups=groups, w_scale=jws, act_quant=aq,
                                  activation="silu", interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **QTOL)


@pytest.mark.parametrize("mode", sorted(QMODES))
def test_quantized_merged_ffn_matches_pallas(mode):
    wmode, aq = QMODES[mode]
    rng = np.random.default_rng(len(mode))
    x = rng.standard_normal((5, 48)).astype(np.float32)
    u = (rng.standard_normal((48, 20)) / np.sqrt(48)).astype(np.float32)
    v = (rng.standard_normal((20, 48)) / np.sqrt(20)).astype(np.float32)
    uq, us, juq, jus = _weights(u, wmode, 1)
    vq, vs, jvq, jvs = _weights(v, wmode, 1)
    y = tk.merged_ffn_op(torch.from_numpy(x), uq, vq, u_scale=us,
                         v_scale=vs, act_quant=aq)
    with jk.force_backend("pallas"):
        yj = jk.merged_ffn_op(jnp.asarray(x), juq, jvq, u_scale=jus,
                              v_scale=jvs, act_quant=aq, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **QTOL)


def test_fp8_weight_quantization_matches():
    w = (np.random.default_rng(3).standard_normal((3, 3, 4, 6)) * 0.2
         ).astype(np.float32)
    q, s = tk.quant.quantize_fp8(torch.from_numpy(w), axis=3)
    jq, js = jk.quant.quantize_fp8(jnp.asarray(w), axis=3)
    assert q.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(q.float().numpy(),
                                  np.asarray(jq).astype(np.float32))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantized_wrappers_check_operands_before_any_build():
    """The CUDA wrappers refuse CPU tensors themselves (the ops never hand
    them one), so nothing reaches nvcc and no launch is counted."""
    x = torch.zeros(1, 5, 5, 4)
    wq = torch.zeros(3, 3, 4, 6, dtype=torch.int8)
    ws = torch.ones(6)
    before = tk.launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        tmc.merged_conv(x, wq, None, w_scale=ws)
    with pytest.raises(ValueError, match="w_scale"):
        tmc.merged_conv(x, wq, None, w_scale=torch.ones(5))
    with pytest.raises(ValueError, match="CUDA device"):
        tdw.depthwise_conv(torch.zeros(1, 5, 5, 6),
                           torch.zeros(3, 3, 1, 6, dtype=torch.int8), None,
                           groups=6, w_scale=ws)
    x2, u, v = torch.zeros(4, 32), torch.zeros(32, 8, dtype=torch.int8), \
        torch.zeros(8, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA device"):
        tmf.merged_ffn(x2, u, v, u_scale=torch.ones(8),
                       v_scale=torch.ones(32))
    with pytest.raises(ValueError, match="together"):
        tmf.merged_ffn(x2, u, v, u_scale=torch.ones(8))
    assert tk.launch_counts() == before


def test_launch_counts_cover_the_quantized_variants():
    from repro_torch.kernels import flash_attention, rglru_scan, rmsnorm
    assert set(tk.launch_counts()) == {
        "merged_conv", "depthwise_conv", "merged_ffn", "merged_conv_q",
        "depthwise_conv_q", "merged_ffn_q", "rmsnorm", "rglru_scan",
        "flash_attention", "rmsnorm_bf16", "flash_attention_bf16",
        "rglru_scan_bwd"}
    tmc.launches_q = tdw.launches_q = tmf.launches_q = 3
    rmsnorm.launches = rglru_scan.launches = flash_attention.launches = 2
    rmsnorm.launches_bf16 = flash_attention.launches_bf16 = 4
    rglru_scan.launches_bwd = 5
    tk.reset_launch_counts()
    assert set(tk.launch_counts().values()) == {0}
