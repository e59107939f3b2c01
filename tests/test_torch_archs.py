"""Every transformer config of the reference's registry through the port,
at CI size, against the JAX package, on the CPU.

For each of the ten ids (``configs.ARCH_IDS``), ``.reduced()`` in fp32
with the same numpy parameters in both packages:

* prefill logits (M-RoPE streams for qwen2-vl, seeded embeddings for the
  embeddings frontends);
* decode logits at every position against the port's prefill (MoE at
  ``capacity_factor`` 8.0, where nothing drops: capacity dropping is
  first come first served across the batch, so a prefill and a one-token
  step drop differently otherwise, in both packages);
* the host's analytic latency columns bit-identical under the JAX
  package's constants, its link rate ``ICI_BW`` included (the MoE
  dispatch term), and the JAX package's tables giving identical plans
  in both packages' DP;
* artifacts crossing both ways with the same sha256 fingerprint and the
  same outputs;
* the full configs' parameter counts, reckoned without allocating
  (``FakeTensorMode`` against ``jax.eval_shape``).

Routing is discontinuous: every MoE call of the port records the smallest
gap between its k-th and (k+1)-th gate, and each test asserts it exceeds
1e-5 before holding logits to max |Δ| ≤ 1e-5 · max |y|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.core import compress as jax_compress
from repro.core import dp as jdp
from repro.core import latency as jlat
from repro.core.tables import build_tables as j_build_tables
from repro.models import transformer as jT
from repro.models import transformer_host as jhost
from repro_torch import runtime as trt
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import dp as tdp
from repro_torch.core import latency as tlat
from repro_torch.core.compress import CompressResult
from repro_torch.core.tables import build_tables as t_build_tables
from repro_torch.models import moe as tM
from repro_torch.models import transformer as tT
from repro_torch.models import transformer_host as thost

from _torch_parity import np_lm_params

RTOL = 1e-5
MARGIN = 1e-5


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = float(np.abs(b).max()) + 1e-9
    assert float(np.abs(a - b).max()) <= RTOL * scale, \
        float(np.abs(a - b).max()) / scale


@pytest.fixture
def margins(monkeypatch):
    """The smallest top-k gate margin of every port MoE call made while
    the test runs (empty for dense configs)."""
    seen = []
    orig = tM.route

    def recorded(p, xt, cfg, forced=None):
        g = torch.softmax((xt @ p["router"]).double(), dim=-1)
        top = torch.topk(g, cfg.experts_per_token + 1, dim=-1).values
        seen.append(float((top[:, -2] - top[:, -1]).min()))
        return orig(p, xt, cfg, forced)
    monkeypatch.setattr(tM, "route", recorded)
    return seen


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_get_config(arch).reduced(), **kw),
            dataclasses.replace(t_get_config(arch).reduced(), **kw))


def _batch(cfg, b, s, seed=2):
    """Numpy batch: tokens or embeddings, and M-RoPE streams (temporal
    ``arange``, height and width of a 2×2 grid, then text positions)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "tokens":
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s))
    else:
        out["embeds"] = (rng.standard_normal((b, s, cfg.d_model)) * 0.3
                         ).astype(np.float32)
    if cfg.rope_kind == "mrope":
        t = np.arange(s)
        h, w = np.where(t < 4, t // 2, t), np.where(t < 4, t % 2, t)
        out["mrope_positions"] = np.broadcast_to(
            np.stack([t, h, w])[:, None], (3, b, s)).astype(np.int32).copy()
    return out


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _step_batch(batch, t):
    return {k: (v[:, :, t:t + 1] if k == "mrope_positions" else v[:, t:t + 1])
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCH_IDS)
def setup(request):
    """Hosts of both packages on the same params, and the JAX package's
    feasible plans (``layermerge`` and ``depth``)."""
    arch = request.param
    jc, tc = _cfgs(arch)
    params = np_lm_params(jc, seed=1)
    jh = jhost.TransformerHost(jc, jax.tree.map(jnp.asarray, params),
                               env=jhost.CostEnv(batch=2, seq=16))
    th = thost.TransformerHost(tc, tT.params_from_numpy(params),
                               env=thost.CostEnv(batch=2, seq=16),
                               device="cpu")
    results = []
    for method in ("layermerge", "depth"):
        for ratio in (0.6, 0.9):
            r = jax_compress(jh, budget_ratio=ratio, P=100, method=method)
            if r is not None:
                results.append(r)
    return arch, params, jh, th, results


def test_forward_matches(setup, margins):
    arch, params, jh, th, _ = setup
    batch = _batch(jh.cfg, 2, 8)
    y = tT.forward(th.cfg, th.params, _t(batch))
    assert tuple(y.shape) == (2, 8, th.cfg.vocab_size)
    assert all(m > MARGIN for m in margins), min(margins)
    _close(y, jT.forward(jh.cfg, jh.params, _j(batch)))


def test_decode_matches_prefill(setup, margins):
    arch, _, _, th, _ = setup
    cfg = th.cfg
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    batch = _batch(cfg, 2, 8, seed=3)
    y = tT.forward(cfg, th.params, _t(batch))
    cache = tT.init_cache(cfg, 2, 8, device="cpu")
    for t in range(8):
        lt, cache = tT.decode_step(cfg, th.params, cache,
                                   _t(_step_batch(batch, t)))
        _close(lt[:, 0], y[:, t])
    assert all(m > MARGIN for m in margins), min(margins)


def _jax_oracle_in_port():
    return tlat.AnalyticOracle(peak_flops=jlat.PEAK_FLOPS_BF16,
                               hbm_bw=jlat.HBM_BW, op_overhead=1e-6,
                               ici_bw=jlat.ICI_BW)


def test_tables_and_plans_match(setup):
    arch, _, jh, th, _ = setup
    assert th.kinds == jh.kinds
    assert [d.growth for d in th.descs()] == [d.growth for d in jh.descs()]
    for method in ("layermerge", "depth"):
        jt = j_build_tables(jh, method=method,
                            latency_oracle=jlat.AnalyticTPUOracle())
        tt = t_build_tables(th, method=method,
                            latency_oracle=_jax_oracle_in_port())
        assert tt.entries.keys() == jt.entries.keys()
        for span, row in jt.entries.items():
            assert tt.entries[span].keys() == row.keys(), span
            for k, (imp, lat, kept) in row.items():
                timp, tlat_, tkept = tt.entries[span][k]
                assert tlat_ == lat, (span, k)           # bit-identical
                assert tkept == kept
                assert timp == pytest.approx(imp, rel=1e-6)
        L = len(jh.descs())
        t_orig = sum(lat for (i, j), row in jt.entries.items() if j - i == 1
                     for k, (imp, lat, kept) in row.items() if k == 0)
        for ratio in (0.6, 0.9):
            a = tdp.solve_dp(L, jt.fn(), ratio * t_orig, 100, method=method,
                             original_k=th.original_k)
            b = jdp.solve_dp(L, jt.fn(), ratio * t_orig, 100, method=method,
                             original_k=jh.original_k)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.plan.to_json() == b.plan.to_json()
    if th.cfg.is_moe:
        # the dispatch term: priced by the JAX package's link rate, and
        # at 0 s by the port's default (one card, no link)
        c = th._block_cost("moe")
        assert c.ici_bytes > 0
        assert dataclasses.astuple(c) == \
            dataclasses.astuple(jh._block_cost("moe"))
        assert _jax_oracle_in_port().segment_latency(c) == \
            jlat.AnalyticTPUOracle().segment_latency(c)
        no_link = tlat.AnalyticOracle(peak_flops=jlat.PEAK_FLOPS_BF16,
                                      hbm_bw=jlat.HBM_BW, op_overhead=1e-6)
        assert no_link.segment_latency(c) < \
            _jax_oracle_in_port().segment_latency(c)


def test_artifacts_cross_both_ways(setup, tmp_path, margins):
    arch, _, jh, th, results = setup
    assert results
    res = results[-1]
    batch = _batch(jh.cfg, 2, 4, seed=6)
    path = str(tmp_path / "j.npz")
    fp = res.save(path)
    art = trt.load(path, device="cpu")
    assert art.fingerprint == fp
    assert trt.fingerprint(art.graph, art.plan, art.meta) == fp
    assert art.graph.meta["config"] == th.cfg
    y = art.apply(batch)
    _close(y, jrt.load(path).apply(_j(batch)))
    tres = CompressResult(plan=res.plan, tables=None,
                          original_latency=res.original_latency,
                          compressed_latency=res.compressed_latency,
                          dp_seconds=0.0, host=th, params=th.params)
    tpath = str(tmp_path / "t.npz")
    tfp = tres.save(tpath, extra_meta={"source": {"arch": arch}})
    jart = jrt.load(tpath)
    assert jart.fingerprint == tfp
    assert jart.graph.meta["config"] == jh.cfg
    tart = trt.load(tpath, device="cpu")
    assert tart.fingerprint == tfp
    _close(tart.apply(batch), jart.apply(_j(batch)))
    assert all(m > MARGIN for m in margins), min(margins)


def test_compressed_decode_matches_prefill(setup):
    """The executor's decode of the most-segmented plan (every kept
    sublayer kind of the arch) reproduces its prefill."""
    arch, _, jh, th, results = setup
    res = max(results, key=lambda r: len(r.plan.segments))
    cfg = th.cfg
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    graph = th.lower_plan(res.plan)
    graph.meta["config"] = cfg
    batch = _batch(cfg, 2, 6, seed=7)
    y = trt.execute(graph, batch, device="cpu")
    cache = trt.init_cache(graph, 2, 6)
    for t in range(6):
        lt, cache = trt.decode_step(graph, cache, _t(_step_batch(batch, t)))
        _close(lt[:, 0], y[:, t])


def test_full_param_count(setup):
    """The full config's parameters, counted from the port's
    ``init_model`` under ``FakeTensorMode`` (nothing allocated), equal
    the JAX package's ``eval_shape`` count."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.runtime.artifact import flatten_tree
    arch = setup[0]
    tc = dataclasses.replace(t_get_config(arch), dtype="float32")
    jc = dataclasses.replace(j_get_config(arch), dtype="float32")
    with FakeTensorMode():
        params, _ = tT.init_model(tc, device="cpu")
        n = sum(t.numel() for t in flatten_tree(params).values())
    shapes = jax.eval_shape(lambda: jT.init_model(jc,
                                                  jax.random.PRNGKey(0))[0])
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
