"""The port's core (plans, segments, DP, merging, costs, tables) against the
JAX package's, on the same numpy inputs.

* plan / segments / dp are copies: the same tables in give bit-identical
  plans out;
* ``conv2d_cost`` and the analytic latency column are bit-identical once
  the JAX package's constants (its roofline peaks and tile budget) are
  passed in;
* the magnitude importance column agrees to 1e-6 relative (ℓ1 norms summed
  in another order);
* merged weights agree within 1e-5.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dp as jdp
from repro.core import latency as jlat
from repro.core import merge as jmerge
from repro.core import segments as jseg
from repro.core.plan import LayerDesc as JLayerDesc
from repro.core.tables import build_tables as j_build_tables
from repro.kernels.merged_conv import _VMEM_BUDGET
from repro.models import cnn_host as jhost
from repro.models import zoo as jzoo
from repro_torch.core import dp as tdp
from repro_torch.core import latency as tlat
from repro_torch.core import merge as tmerge
from repro_torch.core import segments as tseg
from repro_torch.core.plan import LayerDesc as TLayerDesc
from repro_torch.core.tables import build_tables as t_build_tables
from repro_torch.models import cnn as tcnn
from repro_torch.models import cnn_host as thost
from repro_torch.models import zoo as tzoo

from _torch_parity import ZOO, np_params


def _instance(seed, L):
    """Random (i, j) -> {k: (I, T, kept)} table (as in test_dp.py)."""
    rng = np.random.default_rng(seed)
    table = {}
    for i in range(L):
        for j in range(i + 1, L + 1):
            if j - i > 1 and rng.random() < 0.3:
                continue
            opts = {}
            for k in rng.choice(range(1, 12), size=rng.integers(1, 4),
                                replace=False):
                opts[int(k)] = (float(rng.random()),
                                float(rng.integers(1, 11)) * rng.random(),
                                tuple(range(i + 1, j + 1)))
            table[(i, j)] = opts
    return lambda i, j: table.get((i, j), {})


@pytest.mark.parametrize("seed,L", itertools.product(range(4), (2, 4, 7)))
def test_dp_plans_bit_identical(seed, L):
    table = _instance(seed, L)
    for budget in (5.0, 12.0, 40.0):
        for method in ("layermerge", "depth"):
            a = tdp.solve_dp(L, table, budget, 50, method=method)
            b = jdp.solve_dp(L, table, budget, 50, method=method)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.plan.to_json() == b.plan.to_json()
                assert a.objective == b.objective and a.latency == b.latency
        ref = tdp.solve_dp_reference(L, table, budget, 50)
        want = jdp.solve_dp_reference(L, table, budget, 50)
        assert (ref is None) == (want is None)
        if ref is not None:
            assert ref.plan.to_json() == want.plan.to_json()
    rng = np.random.default_rng(seed)
    imp = {l: float(rng.random()) for l in range(1, L + 1)}
    lat = {l: float(rng.integers(1, 6)) for l in range(1, L + 1)}
    assert tdp.solve_knapsack(L, imp, lat, 2.0 * L, 40, forced=(1,)) == \
        jdp.solve_knapsack(L, imp, lat, 2.0 * L, 40, forced=(1,))


@pytest.mark.parametrize("seed", range(6))
def test_segment_enumeration_identical(seed):
    rng = np.random.default_rng(seed)
    spec = [(int(rng.integers(0, 5)), bool(rng.random() < 0.6),
             bool(rng.random() < 0.8), float(rng.random()))
            for _ in range(int(rng.integers(2, 8)))]

    def descs(cls):
        return [cls(index=i + 1, kind="x", growth=g, value=v, prunable=p,
                    linearizable=lin)
                for i, (g, p, lin, v) in enumerate(spec)]
    for depth_mode, cap, max_span in ((False, None, None), (True, None, 3),
                                      (False, 6, 4)):
        a = tseg.SegmentEnumerator(descs(TLayerDesc), offset=1, cap=cap,
                                   depth_mode=depth_mode, max_span=max_span)
        b = jseg.SegmentEnumerator(descs(JLayerDesc), offset=1, cap=cap,
                                   depth_mode=depth_mode, max_span=max_span)
        assert list(a.all_spans()) == list(b.all_spans())


def test_conv2d_cost_bit_identical_with_injected_constants():
    for h, cin, cout, k, s, dw, batch in itertools.product(
            (7, 28, 112), (3, 32, 144), (16, 96), (1, 3, 5, 11), (1, 2),
            (False, True), (1, 8)):
        a = tlat.conv2d_cost(h, h, cin, cout, k, stride=s, depthwise=dw,
                             dtype_bytes=2, batch=batch,
                             tile_budget=_VMEM_BUDGET)
        b = jlat.conv2d_cost(h, h, cin, cout, k, stride=s, depthwise=dw,
                             dtype_bytes=2, batch=batch)
        assert (a.flops, a.hbm_bytes) == (b.flops, b.hbm_bytes)
        assert _jax_oracle_in_port().segment_latency(a) == \
            jlat.AnalyticTPUOracle().segment_latency(b)


@pytest.mark.parametrize("k,s,dw", [(1, 1, False), (1, 2, False),
                                    (3, 2, False), (5, 1, True)])
def test_h100_default_cost_prices_the_port_traffic(k, s, dw):
    """Default costs: the weight once, the executor's pad copy and the
    kernel's read of it (k > 1) or one image read, and the output — no
    tile halo or relayout term."""
    h, w, cin, cout, batch = 10, 12, 4, 4 if dw else 8, 2
    c = tlat.conv2d_cost(h, w, cin, cout, k, stride=s, depthwise=dw,
                         batch=batch)
    ho, wo = -(-h // s), -(-w // s)
    wbytes = 4 * k * k * cin * (1 if dw else cout)
    inp = 4 * h * w * cin + (2 * 4 * (h + k - 1) * (w + k - 1) * cin
                             if k > 1 else 0)
    assert c.hbm_bytes == wbytes + batch * (inp + 4 * ho * wo * cout)
    assert c.flops == 2.0 * batch * ho * wo * k * k * cin * (
        1 if dw else cout)


def test_h100_defaults_are_not_tpu_constants():
    ora = tlat.AnalyticOracle()
    assert (ora.peak_flops, ora.hbm_bw) == (67e12, 3.35e12)
    assert ora.peak_flops != jlat.PEAK_FLOPS_BF16
    assert ora.hbm_bw != jlat.HBM_BW


def _hosts(name, seed=0, max_span=None):
    jnet = getattr(jzoo, name)(**ZOO[name])
    tnet = getattr(tzoo, name)(**ZOO[name])
    assert repr(jnet).replace("repro.", "") == repr(tnet).replace(
        "repro_torch.", "")
    params = np_params(jnet, seed)
    jh = jhost.CNNHost(jnet, jax.tree.map(jnp.asarray, params), batch=2,
                       max_span=max_span)
    th = thost.CNNHost(tnet, tcnn.params_from_numpy(params, "cpu"), batch=2,
                       dtype_bytes=2, max_span=max_span,
                       tile_budget=_VMEM_BUDGET, device="cpu")
    return jh, th


def _jax_oracle_in_port():
    """The JAX package's roofline constants in the port's oracle (its
    ICI term is zero for every CNN segment)."""
    return tlat.AnalyticOracle(peak_flops=jlat.PEAK_FLOPS_BF16,
                               hbm_bw=jlat.HBM_BW, op_overhead=1e-6)


@pytest.mark.parametrize("name,max_span", [("tiny_resnet", None),
                                           ("tiny_mobilenet", None),
                                           ("tiny_unet", 3)])
def test_tables_match_and_same_tables_give_same_plan(name, max_span):
    jh, th = _hosts(name, max_span=max_span)
    jt = j_build_tables(jh, latency_oracle=jlat.AnalyticTPUOracle())
    tt = t_build_tables(th, latency_oracle=_jax_oracle_in_port())
    assert tt.entries.keys() == jt.entries.keys()
    for span, row in jt.entries.items():
        assert tt.entries[span].keys() == row.keys(), span
        for k, (imp, lat, kept) in row.items():
            timp, tlat_, tkept = tt.entries[span][k]
            assert tlat_ == lat, (span, k)             # bit-identical
            assert tkept == kept
            assert timp == pytest.approx(imp, rel=1e-6)
    assert tt.num_pruned == jt.num_pruned
    assert tt.stats.num_latency_buckets == jt.stats.num_latency_buckets
    L = jh.net.L
    t_orig = sum(lat for (i, j), row in jt.entries.items() if j - i == 1
                 for k, (imp, lat, kept) in row.items()
                 if k == jh.original_k(j))
    for ratio in (0.5, 0.7, 0.9):
        a = tdp.solve_dp(L, jt.fn(), ratio * t_orig, 100,
                         original_k=th.original_k)
        b = jdp.solve_dp(L, jt.fn(), ratio * t_orig, 100,
                         original_k=jh.original_k)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.plan.to_json() == b.plan.to_json()


def test_bucketed_latencies_equal_the_sequential_walk():
    from repro_torch.core import probe_engine
    from repro_torch.core.tables import enumerate_probes
    _, th = _hosts("tiny_resnet")
    segs = [p[5] for p in enumerate_probes(th)]
    ora = _jax_oracle_in_port()
    stats = probe_engine.EngineStats()
    assert probe_engine.measure_latencies(th, segs, ora, stats=stats) == \
        [ora.segment_latency(th.segment_cost(s)) for s in segs]
    assert stats.num_latency_buckets < len(segs)


def test_wallclock_oracle_times_each_signature_once():
    """``T_orig`` and the tables of one compress call read the same
    timing of each shape; the artifact's oracle token leaves the held
    timings out."""
    import json

    from repro_torch.core import compress, probe_engine

    class CountingOracle(tlat.WallClockOracle):
        calls = 0

        def time_callable_stats(self, fn, *, warmup=None):  # the card's
            CountingOracle.calls += 1                       # timing, stubbed
            return 1e-3 + 1e-6 * CountingOracle.calls, 0.0

    _, th = _hosts("tiny_resnet")
    ora = CountingOracle()
    token = tlat.oracle_token(ora)
    res = compress(th, budget_ratio=0.8, latency_oracle=ora)
    assert CountingOracle.calls == len(ora.measured) == \
        res.tables.stats.num_latency_buckets
    layer_sigs = {th.probe_signature(s) for s in res.plan.segments
                  if s.original}
    assert layer_sigs <= set(ora.measured)
    probe_engine.layer_latencies(th, ora)
    assert CountingOracle.calls == len(ora.measured)
    assert tlat.oracle_token(ora) == token
    json.loads(token)


def test_probe_signatures_and_costs_match():
    jh, th = _hosts("tiny_mobilenet")
    from repro_torch.core.tables import enumerate_probes
    for *_, seg in enumerate_probes(th):
        assert th.probe_signature(seg) == jh.probe_signature(seg)
        a, b = th.segment_cost(seg), jh.segment_cost(seg)
        assert (a.flops, a.hbm_bytes) == (b.flops, b.hbm_bytes)


# -- merging -------------------------------------------------------------------

def _w(rng, *shape):
    return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:3]))
            ).astype(np.float32)


@pytest.mark.parametrize("dw1,dw2,s1", itertools.product(
    (False, True), (False, True), (1, 2, 3)))
def test_merge_conv_pair_matches(dw1, dw2, s1):
    rng = np.random.default_rng(int(dw1) * 4 + int(dw2) * 2 + s1)
    c = 6
    w1 = _w(rng, 3, 3, 1, c) if dw1 else _w(rng, 3, 3, 5, c)
    w2 = _w(rng, 2, 5, 1, c) if dw2 else _w(rng, 2, 5, c, 7)
    a, adw = tmerge.merge_conv_pair(torch.from_numpy(w1),
                                    torch.from_numpy(w2), stride1=s1,
                                    dw1=dw1, dw2=dw2)
    b, bdw = jmerge.merge_conv_pair(jnp.asarray(w1), jnp.asarray(w2),
                                    stride1=s1, dw1=dw1, dw2=dw2)
    assert adw == bdw
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                               atol=1e-5)


def test_merge_conv_chain_matches():
    rng = np.random.default_rng(11)
    ws = [_w(rng, 3, 3, 4, 8), _w(rng, 3, 3, 1, 8), _w(rng, 1, 1, 8, 5)]
    strides, dws = [1, 2, 1], [False, True, False]
    a = tmerge.merge_conv_chain([torch.from_numpy(w) for w in ws], strides,
                                dws)
    b = jmerge.merge_conv_chain([jnp.asarray(w) for w in ws], strides, dws)
    assert a[1:] == b[1:]
    np.testing.assert_allclose(a[0].numpy(), np.asarray(b[0]), rtol=1e-5,
                               atol=1e-5)


def test_bias_skip_bn_and_identity_match():
    rng = np.random.default_rng(9)
    w = _w(rng, 3, 3, 6, 6)
    wd = _w(rng, 5, 5, 1, 6)
    b1, b2 = (rng.standard_normal(6).astype(np.float32) for _ in range(2))
    T, J = torch.from_numpy, jnp.asarray
    for ww, dw in ((w, False), (wd, True)):
        np.testing.assert_allclose(
            tmerge.merge_bias_through(T(ww), T(b1), T(b2), dw2=dw).numpy(),
            np.asarray(jmerge.merge_bias_through(J(ww), J(b1), J(b2),
                                                 dw2=dw)),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(
            tmerge.fuse_skip_add(T(ww), depthwise=dw).numpy(),
            np.asarray(jmerge.fuse_skip_add(J(ww), depthwise=dw)))
    g, be, mu = (rng.standard_normal(6).astype(np.float32) for _ in range(3))
    var = rng.random(6).astype(np.float32) + 0.5
    a = tmerge.fold_batchnorm(T(w), T(b1), T(g), T(be), T(mu), T(var))
    b = jmerge.fold_batchnorm(J(w), J(b1), J(g), J(be), J(mu), J(var))
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(tmerge.identity_kernel(4).numpy(),
                                  np.asarray(jmerge.identity_kernel(4)))
