"""The port's RecurrentGemma path (RG-LRU + local attention) against the
JAX package's, on the CPU.

The RG-LRU block and its decode step, then RecurrentGemma-2B reduced to CI
size (3 layers: rglru, rglru, attn_local; d 32, rnn_width 32, window 8),
with the same numpy parameters in both packages:

* prefill logits, and decode logits at every position of a 12-token prompt
  (the 8-entry ring buffer of the local attention wraps);
* the host's latency columns bit-identical under the JAX package's
  constants, and the same tables giving bit-identical plans;
* ``execute`` of a merged plan against the JAX package's and against
  ``replaced_apply``; compressed decode against the JAX executor's;
* artifacts crossing both ways with their fingerprints verified, and the
  CLI's artifact loading in the JAX package.

Tolerance: max |Δ| ≤ 1e-5 · max |y|.  The JAX block scans with
``lax.associative_scan`` and the port sequentially (``rglru_scan_op``'s
plain version): the same recurrence summed in another order, so fp32
reassociation and never bitwise.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.core import compress as jax_compress
from repro.core import dp as jdp
from repro.core import latency as jlat
from repro.core.tables import build_tables as j_build_tables
from repro.models import rglru as jRG
from repro.models import transformer as jT
from repro.models import transformer_host as jhost
from repro.runtime import executor as jex
from repro_torch import runtime as trt
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import dp as tdp
from repro_torch.core import latency as tlat
from repro_torch.core.compress import CompressResult
from repro_torch.core.tables import build_tables as t_build_tables
from repro_torch.models import rglru as tRG
from repro_torch.models import transformer as tT
from repro_torch.models import transformer_host as thost

from _torch_parity import np_lm_params, rg_configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
JC, TC = rg_configs()


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = float(np.abs(b).max()) + 1e-9
    assert float(np.abs(a - b).max()) <= RTOL * scale, \
        float(np.abs(a - b).max()) / scale


def _tokens(shape, seed=2):
    return np.random.default_rng(seed).integers(0, JC.vocab_size, shape)


def _block_params(seed=0):
    """Layer 0's RG-LRU block params, as numpy."""
    params = np_lm_params(JC, seed=seed)
    return {k: np.asarray(v[0])
            for k, v in params["groups"][0]["temporal"].items()}


def test_reduced_config_is_the_issue_size():
    assert JC.layer_kinds() == ("rglru", "rglru", "attn_local")
    assert (JC.d_model, JC.rnn_width, JC.local_window) == (32, 32, 8)
    assert dataclasses.asdict(TC) == dataclasses.asdict(JC)


@pytest.mark.parametrize("b,s", [(2, 7), (1, 13), (3, 1)])
def test_rglru_block_and_decode_match(b, s):
    p = _block_params(seed=b + s)
    x = np.random.default_rng(s).standard_normal((b, s, 32)).astype(
        np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    y = tRG.rglru_block(tp, torch.from_numpy(x), TC)
    _close(y, jRG.rglru_block(jp, jnp.asarray(x), JC))
    tstate = tRG.init_rglru_state(TC, b, torch.float32)
    jstate = jRG.init_rglru_state(JC, b, jnp.float32)
    jstep = jax.jit(lambda x, st: jRG.rglru_decode(jp, x, JC, st))
    for t in range(s):
        yt, tstate = tRG.rglru_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                      TC, tstate)
        yj, jstate = jstep(jnp.asarray(x[:, t:t + 1]), jstate)
        _close(yt, yj)
        _close(tstate["h"], jstate["h"])
        _close(tstate["conv"], jstate["conv"])
        _close(yt[:, 0], y[:, t])          # decode follows prefill


def test_gates_and_conv_match():
    p = _block_params(seed=5)
    u = np.random.default_rng(5).standard_normal((2, 6, 32)).astype(
        np.float32) * 3
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for got, want in zip(tRG._gates(tp, torch.from_numpy(u)),
                         jRG._gates(jp, jnp.asarray(u))):
        _close(got, want)
    state = np.random.default_rng(6).standard_normal((2, 3, 32)).astype(
        np.float32)
    for st in (None, state):
        got = tRG._causal_conv1d(
            tp, torch.from_numpy(u), None if st is None
            else torch.from_numpy(st))
        want = jRG._causal_conv1d(
            jp, jnp.asarray(u), None if st is None else jnp.asarray(st))
        for g, w in zip(got, want):
            _close(g, w)


def test_init_draws_the_reference_distribution():
    """``init_rglru``: Λ such that ``-log a`` at r = 1 is C times ``-log``
    of a uniform draw in (0.9^C, 0.999^C), the JAX package's shapes."""
    p, ax = tRG.init_rglru(TC, torch.Generator().manual_seed(0),
                           torch.float32)
    jshapes = jax.eval_shape(
        lambda: jRG.init_rglru(JC, jax.random.PRNGKey(0), jnp.float32)[0])
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jshapes.items()}
    assert ax == jRG.rglru_axes()
    assert tRG.RGLRU_STATE_AXES == jRG.RGLRU_STATE_AXES
    u = torch.exp(-torch.nn.functional.softplus(p["lam"]))
    assert float(u.min()) >= 0.9 ** tRG.C_DECAY - 1e-6
    assert float(u.max()) <= 0.999 ** tRG.C_DECAY + 1e-6


def _jax_oracle_in_port():
    return tlat.AnalyticOracle(peak_flops=jlat.PEAK_FLOPS_BF16,
                               hbm_bw=jlat.HBM_BW, op_overhead=1e-6)


@pytest.fixture(scope="module")
def rg():
    """Hosts of both packages on the same params, and the JAX package's
    feasible plans."""
    params = np_lm_params(JC, seed=1)
    jh = jhost.TransformerHost(JC, jax.tree.map(jnp.asarray, params),
                               env=jhost.CostEnv(batch=2, seq=16))
    th = thost.TransformerHost(TC, tT.params_from_numpy(params),
                               env=thost.CostEnv(batch=2, seq=16),
                               device="cpu")
    results = []
    for method in ("layermerge", "depth"):
        for ratio in (0.5, 0.7, 0.9):
            r = jax_compress(jh, budget_ratio=ratio, P=100, method=method)
            if r is not None:
                results.append(r)
    return jh, th, results


def test_params_and_axes_round_trip(rg):
    jh, th, _ = rg
    back = tT.params_to_numpy(th.params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jh.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tT.model_axes(TC) == jT.model_axes(JC)
    _, axes = tT.init_model(TC, device="cpu")
    assert axes == jT.model_axes(JC)


def test_forward_and_wrapped_decode_match(rg):
    """Prefill logits, and teacher-forced decode logits at each of 12
    positions: the local attention's 8-entry ring buffer wraps."""
    jh, th, _ = rg
    toks = _tokens((2, 12))
    y = tT.forward(TC, th.params, {"tokens": torch.from_numpy(toks)})
    _close(y, jT.forward(JC, jh.params, {"tokens": jnp.asarray(toks)}))
    jcache = jT.init_cache(JC, 2, 12)
    tcache = tT.init_cache(TC, 2, 12, device="cpu")
    assert tcache[0].keys() == {"h", "conv"}
    assert tcache[2]["k"].shape[1] == 8
    jstep = jax.jit(lambda p, c, b: jT.decode_step(JC, p, c, b))
    for t in range(12):
        lj, jcache = jstep(jh.params, jcache,
                           {"tokens": jnp.asarray(toks[:, t:t + 1])})
        lt, tcache = tT.decode_step(TC, th.params, tcache,
                                    {"tokens": torch.from_numpy(
                                        toks[:, t:t + 1])})
        _close(lt, lj)
    # the prefill's local attention is masked to the window (12 > 8), so
    # its last position is the decode's
    _close(lt[:, 0], y[:, -1])


def test_tables_match_and_same_tables_give_same_plan(rg):
    jh, th, _ = rg
    assert [(d.kind, d.growth, d.prunable, d.linearizable)
            for d in th.descs()] == [(d.kind, d.growth, d.prunable,
                                      d.linearizable) for d in jh.descs()]
    assert th._block_cost("rglru") == \
        thost.CostBreakdown(*dataclasses.astuple(
            jh._block_cost("rglru"))[:2])
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
        for ratio in (0.5, 0.7, 0.9):
            a = tdp.solve_dp(L, jt.fn(), ratio * t_orig, 100, method=method,
                             original_k=th.original_k)
            b = jdp.solve_dp(L, jt.fn(), ratio * t_orig, 100, method=method,
                             original_k=jh.original_k)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.plan.to_json() == b.plan.to_json()


def test_execute_matches_and_merging_is_exact(rg):
    jh, th, results = rg
    assert results
    toks = _tokens((2, 6))
    lowrank = 0
    for r in results:
        tgraph = th.lower_plan(r.plan)
        census = trt.count_units(tgraph)
        lowrank += census.get("lowrank", 0)
        y = trt.execute(tgraph, {"tokens": toks}, device="cpu")
        _close(y, jrt.execute(jh.lower_plan(r.plan),
                              {"tokens": jnp.asarray(toks)}))
        fn, p = th.replaced_apply(r.plan)
        _close(y, fn(p, {"tokens": toks}))
    assert lowrank > 0, "no plan merged an FFN"
    assert any(trt.count_units(th.lower_plan(r.plan)).get(
        "sublayer:rglru", 0) for r in results)


def test_compressed_decode_matches(rg):
    """Decode through a merged plan's units, 12 positions (the ring buffer
    wraps), against the JAX executor and against the merged prefill."""
    jh, th, results = rg
    r = max(results, key=lambda r: len(r.plan.segments))
    jg, tg = jh.lower_plan(r.plan), th.lower_plan(r.plan)
    toks = _tokens((3, 12), seed=4)
    jcache, tcache = jex.init_cache(jg, 3, 12), trt.init_cache(tg, 3, 12)
    jstep = jax.jit(lambda c, b: jex.decode_step(jg, c, b))
    for t in range(12):
        lj, jcache = jstep(jcache, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        lt, tcache = trt.decode_step(tg, tcache,
                                     {"tokens": torch.from_numpy(
                                         toks[:, t:t + 1])})
        _close(lt, lj)
    _close(lt[:, 0], trt.execute(tg, {"tokens": toks}, device="cpu")[:, -1])


def _spec_and_arrays(path):
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    spec = json.loads(data.pop("__spec__").item())
    data.pop("__fingerprint__")
    return spec, data


def test_artifacts_cross_both_ways(rg, tmp_path):
    jh, th, results = rg
    res = results[-1]
    toks = _tokens((2, 5), seed=6)
    path = str(tmp_path / "rg.npz")
    fp = res.save(path)
    art = trt.load(path, device="cpu")
    assert art.fingerprint == fp
    assert trt.fingerprint(art.graph, art.plan, art.meta) == fp
    assert art.graph.meta["config"] == th.cfg
    _close(art.apply({"tokens": toks}),
           jrt.load(path).apply({"tokens": jnp.asarray(toks)}))
    tres = CompressResult(plan=res.plan, tables=None,
                          original_latency=res.original_latency,
                          compressed_latency=res.compressed_latency,
                          dp_seconds=0.0, host=th, params=th.params)
    tpath = str(tmp_path / "rg_port.npz")
    tfp = tres.save(tpath, extra_meta={"source": {"arch": "rg"}})
    jart = jrt.load(tpath)
    assert jart.fingerprint == tfp
    assert jart.graph.meta["config"] == jh.cfg
    _close(trt.load(tpath, device="cpu").apply({"tokens": toks}),
           jart.apply({"tokens": jnp.asarray(toks)}))
    paths = [str(tmp_path / "j.npz"), str(tmp_path / "t.npz")]
    meta = {"source": {"arch": "rg"}}
    jrt.save(paths[0], jh.lower_plan(res.plan), plan=res.plan, meta=meta)
    trt.save(paths[1], th.lower_plan(res.plan), plan=res.plan, meta=meta)
    (js, ja), (ts, ta) = (_spec_and_arrays(p) for p in paths)
    assert js == ts
    assert {k: (v.shape, v.dtype) for k, v in ja.items()} == \
        {k: (v.shape, v.dtype) for k, v in ta.items()}


def test_cli_artifact_loads_in_jax(tmp_path):
    out = str(tmp_path / "rg.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.compress", "--arch",
         "recurrentgemma-2b", "--device", "cpu", "--method", "depth",
         "--budget-ratio", "0.9", "--seq", "16", "--out", out],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert '"predicted_speedup"' in proc.stdout
    jart = jrt.load(out)
    tart = trt.load(out, device="cpu")
    assert jart.fingerprint == tart.fingerprint
    assert jart.meta["source"] == {"arch": "recurrentgemma-2b", "seed": 0,
                                   "family": "transformer", "reduced": True}
    census = trt.count_units(tart.graph)
    assert census.get("lowrank", 0) > 0 and census.get("sublayer:rglru", 0)
    toks = _tokens((2, 5))
    _close(tart.apply({"tokens": toks}),
           jart.apply({"tokens": jnp.asarray(toks)}))


def test_full_config_is_the_reference_config():
    full = t_get_config("recurrentgemma-2b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size, full.rnn_width,
            full.local_window) == (26, 2560, 10, 1, 256, 7680, 256000, 2560,
                                   2048)
    assert full.layer_kinds()[:3] == ("rglru", "rglru", "attn_local")
