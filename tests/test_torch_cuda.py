"""The hand-written CUDA kernels on the card (marked ``cuda``; they skip
where ``torch.cuda.is_available()`` is false).  This file imports neither
JAX nor the JAX package, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Kernel vs plain version: ``rtol = atol = 1e-4`` (fp32 sums in another
order; an indexing fault is O(1)).
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tk.merged_ffn_op(x, u.to(torch.int8), v.to(torch.int8),
                         u_scale=torch.ones(8, device=dev),
                         v_scale=torch.ones(32, device=dev))


def test_quantized_paths_raise_on_the_card():
    dev = _card()
    x, w, b = _data(0, (1, 5, 5, 4), (3, 3, 4, 6))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tk.merged_conv_op(x.to(dev), w.to(dev), b.to(dev),
                          w_scale=torch.ones(6, device=dev))
    xd, wd, bd = _data(0, (1, 5, 5, 6), (3, 3, 1, 6))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tk.depthwise_conv_op(xd.to(dev), wd.to(dev), bd.to(dev),
                             w_scale=torch.ones(6, device=dev))


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
