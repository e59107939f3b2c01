"""The port's rank-merge pieces against the JAX package's: the
``merged_ffn`` op, the rank-merge functions and the transformer cost
helpers.

On the CPU the port's ``merged_ffn_op`` runs its plain version; the JAX op
runs its Pallas kernel in interpret mode (``force_backend("pallas")``,
``interpret=True``), as the JAX package's own tests do.  Tolerances:
``rtol = atol = 2e-5`` for the op (fp32 sums in different orders), 1e-5
of max |U·V| for the merges (compared through ``u @ v``: the SVD's signs
differ between LAPACK and XLA, so the factors themselves may), and bit
identity for the cost arithmetic.  The CUDA kernel is held against the
plain version on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as jk
from repro.core import latency as jlat
from repro.core import merge as jmerge
from repro_torch import kernels as tk
from repro_torch.core import latency as tlat
from repro_torch.core import merge as tmerge

TOL = dict(rtol=2e-5, atol=2e-5)


def _ffn_data(seed, m, d, r):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    u = (rng.standard_normal((d, r)) / np.sqrt(d)).astype(np.float32)
    v = (rng.standard_normal((r, d)) / np.sqrt(r)).astype(np.float32)
    return x, u, v


@pytest.mark.parametrize("m,d,r", [(1, 32, 1), (8, 96, 24), (37, 96, 130),
                                   (5, 32, 48), (130, 40, 7)])
def test_merged_ffn_op_matches_pallas(m, d, r):
    x, u, v = _ffn_data(m + d + r, m, d, r)
    y = tk.merged_ffn_op(torch.from_numpy(x), torch.from_numpy(u),
                         torch.from_numpy(v))
    with jk.force_backend("pallas"):
        yj = jk.merged_ffn_op(jnp.asarray(x), jnp.asarray(u), jnp.asarray(v),
                              interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)


def test_merged_ffn_op_keeps_leading_axes():
    x, u, v = _ffn_data(1, 6, 32, 9)
    x3 = torch.from_numpy(x).reshape(2, 3, 32)
    y = tk.merged_ffn_op(x3, torch.from_numpy(u), torch.from_numpy(v))
    assert y.shape == (2, 3, 32)
    np.testing.assert_allclose(
        y.reshape(6, 32).numpy(),
        np.asarray(jk.merged_ffn_ref(jnp.asarray(x), jnp.asarray(u),
                                     jnp.asarray(v))), **TOL)


@pytest.mark.parametrize("mode,act_quant", [("int8", "none"),
                                            ("int8", "w8a8"),
                                            ("fp8", "none")])
def test_quantized_merged_ffn_plain_versions_match(mode, act_quant):
    x, u, v = _ffn_data(7, 9, 32, 20)
    uq, us = tk.quant.quantize_weight(torch.from_numpy(u), mode, axis=1)
    vq, vs = tk.quant.quantize_weight(torch.from_numpy(v), mode, axis=1)
    juq, jus = jk.quant.quantize_weight(jnp.asarray(u), mode, axis=1)
    jvq, jvs = jk.quant.quantize_weight(jnp.asarray(v), mode, axis=1)
    np.testing.assert_array_equal(uq.float().numpy(),
                                  np.asarray(juq).astype(np.float32))
    np.testing.assert_array_equal(vs.numpy(), np.asarray(jvs))
    y = tk.merged_ffn_op(torch.from_numpy(x), uq, vq, u_scale=us,
                         v_scale=vs, act_quant=act_quant)
    yj = jk.merged_ffn_qref(jnp.asarray(x), juq, jvq, jus, jvs,
                            act_quant=act_quant)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(
        tk.merged_ffn_qref(torch.from_numpy(x), uq, vq, us, vs,
                           act_quant=act_quant).numpy(), np.asarray(yj),
        **TOL)


def test_kernel_wrapper_checks_operands_before_any_build():
    """The CUDA wrapper refuses CPU tensors and mismatched shapes itself
    (the op never hands it a CPU tensor), so nothing reaches nvcc."""
    from repro_torch.kernels import merged_ffn as mf
    x, u, v = (torch.from_numpy(a) for a in _ffn_data(0, 4, 32, 8))
    before = mf.launches
    with pytest.raises(ValueError, match="CUDA device"):
        mf.merged_ffn(x, u, v)
    with pytest.raises(ValueError, match="merged_ffn"):
        mf.merged_ffn(x, u, v[:, :16])
    with pytest.raises(ValueError, match="2-D"):
        mf.merged_ffn(x[None], u, v)
    assert mf.launches == before


# -- rank merge ------------------------------------------------------------------

def _factors(seed, d, ranks):
    rng = np.random.default_rng(seed)
    return [((rng.standard_normal((d, r)) / np.sqrt(d)).astype(np.float32),
             (rng.standard_normal((r, d)) / np.sqrt(r)).astype(np.float32))
            for r in ranks]


def _close_product(tu, tv, ju, jv):
    a = (tu @ tv).numpy()
    b = np.asarray(ju @ jv)
    assert tu.shape == ju.shape and tv.shape == jv.shape
    assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


@pytest.mark.parametrize("ranks", [(3, 5), (4, 4, 4), (16, 1, 9, 2)])
def test_rank_merge_chain_matches(ranks):
    fs = _factors(len(ranks), 24, ranks)
    tu, tv = tmerge.merge_linear_residual_chain(
        [(torch.from_numpy(u), torch.from_numpy(v)) for u, v in fs])
    ju, jv = jmerge.merge_linear_residual_chain(
        [(jnp.asarray(u), jnp.asarray(v)) for u, v in fs])
    assert tu.shape == (24, sum(ranks))
    _close_product(tu, tv, ju, jv)
    # the merge is exact: the chain of residual maps, applied in turn
    x = np.random.default_rng(0).standard_normal((3, 24)).astype(np.float32)
    y = x
    for u, v in fs:
        y = y + (y @ u) @ v
    np.testing.assert_allclose((torch.from_numpy(x) + (torch.from_numpy(x)
                                @ tu) @ tv).numpy(), y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ranks,cap", [((30, 30), 24), ((48,), 32),
                                       ((5, 6), 24)])
def test_truncate_rank_matches(ranks, cap):
    d = max(cap, 24)
    fs = _factors(cap, d, ranks)
    tu, tv = tmerge.merge_linear_residual_chain(
        [(torch.from_numpy(u), torch.from_numpy(v)) for u, v in fs])
    ju, jv = jmerge.merge_linear_residual_chain(
        [(jnp.asarray(u), jnp.asarray(v)) for u, v in fs])
    tu, tv = tmerge.truncate_rank(tu, tv, cap)
    ju, jv = jmerge.truncate_rank(ju, jv, cap)
    _close_product(tu, tv, ju, jv)
    np.testing.assert_allclose(
        tmerge.dense_residual(tu, tv).numpy(),
        np.asarray(jmerge.dense_residual(ju, jv)), rtol=1e-5, atol=1e-5)


def test_truncate_rank_refuses_bf16_as_the_reference_does():
    u = torch.randn(8, 12, generator=torch.Generator().manual_seed(0))
    v = torch.randn(12, 8, generator=torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError):
        tmerge.truncate_rank(u.bfloat16(), v.bfloat16(), 8)


# -- cost arithmetic (exact) -----------------------------------------------------

def test_matmul_and_rank_ffn_cost_bit_identical():
    for m in (1, 7.0, 1024.0, 8 * 2048 / 1):
        for kdim, n, by in ((576, 1536, 2), (32, 48, 4), (96, 1, 2)):
            a, b = tlat.matmul_cost(m, kdim, n, by), \
                jlat.matmul_cost(m, kdim, n, by)
            assert (a.flops, a.hbm_bytes) == (b.flops, b.hbm_bytes)
        for d, r in ((576, 576), (576, 1536), (32, 7), (96, 0)):
            a, b = tlat.rank_ffn_cost(m, d, r), jlat.rank_ffn_cost(m, d, r)
            assert (a.flops, a.hbm_bytes) == (b.flops, b.hbm_bytes)
