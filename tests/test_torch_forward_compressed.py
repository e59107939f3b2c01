"""The LayerMerge-compressed forward and the abstract-plan helpers of the
port against the JAX package, on the CPU, with the same numpy inputs.

* ``transformer.forward_compressed`` (the legacy tuple units) against
  ``repro``'s on the graphs of the JAX package's plans, for every
  transformer id at CI size, at budgets 0.6 and 0.8, merged and replaced,
  and the port's ``execute`` against its own ``forward_compressed``: max
  |Δ| ≤ 1e-4 · max |y| (``tests/test_runtime.py``'s ``_allclose``);
* ``moe.moe_ffn(num_groups=)`` at 1, 2 and 4 groups against ``repro``'s
  grouped dispatch (and ``grouped_routing`` as its stand-in);
* ``quant.dequantize_int8``: the object ``optim.compress`` re-exports,
  and its values;
* ``transformer.cache_axes(cfg)`` equal to ``repro``'s for every id;
* ``abstract_plan`` / ``plan_units_spec`` equal to ``repro``'s with
  ``repro``'s oracle constants injected, every id at CI size (at full
  size the reference's DP takes minutes for command-r-plus) and
  SmolLM-135M at full size; ``compressed_model_axes`` and the shapes of
  ``init_compressed_model`` equal to ``repro``'s;
* ``forward_compressed_spec`` against ``repro``'s (mirroring
  ``tests/test_transformer_compress.py``'s abstract-plan test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.core import compress as j_compress
from repro.core import latency as jlat
from repro.kernels import quant as jQ
from repro.models import moe as jM
from repro.models import transformer as jT
from repro.models import transformer_host as jhost
from repro_torch import runtime as trt
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import latency as tlat
from repro_torch.kernels import quant as tQ
from repro_torch.models import moe as tM
from repro_torch.models import transformer as tT
from repro_torch.models import transformer_host as thost
from repro_torch.optim import compress as tOC

from _torch_parity import np_lm_params

RTOL = 1e-4
MARGIN = 1e-5


def _allclose(a, b, rtol=RTOL):
    """``tests/test_runtime.py``'s criterion: max |a − b| / max |a|."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = float(np.abs(a).max()) + 1e-9
    assert float(np.abs(a - b).max()) / scale < rtol, \
        float(np.abs(a - b).max()) / scale


def _jax_oracle_in_port():
    return tlat.AnalyticOracle(peak_flops=jlat.PEAK_FLOPS_BF16,
                               hbm_bw=jlat.HBM_BW, op_overhead=1e-6,
                               ici_bw=jlat.ICI_BW)


@pytest.fixture
def margins(monkeypatch):
    """The smallest top-k gate margin of every port MoE call of the test."""
    seen = []
    orig = tM.route

    def recorded(p, xt, cfg, forced=None):
        g = torch.softmax((xt @ p["router"]).double(), dim=-1)
        top = torch.topk(g, cfg.experts_per_token + 1, dim=-1).values
        seen.append(float((top[:, -2] - top[:, -1]).min()))
        return orig(p, xt, cfg, forced)
    monkeypatch.setattr(tM, "route", recorded)
    return seen


def _batch(cfg, b, s, seed=2):
    rng = np.random.default_rng(seed)
    out = {"positions": np.broadcast_to(np.arange(s)[None], (b, s))
           .astype(np.int32).copy()}
    if cfg.frontend == "tokens":
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)) \
            .astype(np.int32)
    else:
        out["embeds"] = (rng.standard_normal((b, s, cfg.d_model)) * 0.3
                         ).astype(np.float32)
    if cfg.rope_kind == "mrope":
        out["mrope_positions"] = np.broadcast_to(
            np.arange(s)[None, None], (3, b, s)).astype(np.int32).copy()
    return out


def _legacy(graph):
    return [("merged", (u.params["u"], u.params["v"]))
            if u.kind == "lowrank" else
            ("orig", {"norm": u.params["norm"], "p": u.params["p"],
                      "kind": u.sub_kind})
            for u in graph.units]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_compressed_matches_repro(arch, margins):
    jc = j_get_config(arch).reduced()
    tc = t_get_config(arch).reduced()
    params = np_lm_params(jc, seed=1)
    jh = jhost.TransformerHost(jc, jax.tree.map(jnp.asarray, params),
                               env=jhost.CostEnv(batch=2, seq=16))
    th = thost.TransformerHost(tc, tT.params_from_numpy(params),
                               env=thost.CostEnv(batch=2, seq=16),
                               device="cpu")
    batch = _batch(jc, 2, 8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tested = 0
    for ratio in (0.6, 0.8):
        res = j_compress(jh, budget_ratio=ratio, P=100)
        if res is None:
            continue
        for merged in (False, True):
            y_ref = jT.forward_compressed(
                jc, jh.params, _legacy(jh.lower_plan(res.plan,
                                                     merged=merged)), jb)
            graph = th.lower_plan(res.plan, merged=merged)
            y = tT.forward_compressed(tc, th.params, _legacy(graph), tb)
            _allclose(y_ref, y)
            _allclose(y, trt.execute(graph, tb, device="cpu"))
        tested += 1
    assert tested > 0
    assert all(m > MARGIN for m in margins), min(margins)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_ffn_groups_match_repro(groups, margins):
    """The grouped dispatch at the capacity factor 1.0, where tokens drop
    (a group's capacity counts its own tokens only).  Seed 7's routing
    has every top-k margin above 1e-5 (at seed 5 one is 3.5e-6: a choice
    reassociation may flip), which the test asserts."""
    cfg = t_get_config("granite-moe-1b-a400m").reduced()
    jcfg = j_get_config("granite-moe-1b-a400m").reduced()
    rng = np.random.default_rng(7)
    p = {"router": rng.standard_normal((cfg.d_model, cfg.num_experts)),
         "w_gate": rng.standard_normal((cfg.num_experts, cfg.d_model,
                                        cfg.moe_dff)) * 0.2,
         "w_up": rng.standard_normal((cfg.num_experts, cfg.d_model,
                                      cfg.moe_dff)) * 0.2,
         "w_down": rng.standard_normal((cfg.num_experts, cfg.moe_dff,
                                        cfg.d_model)) * 0.2}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((4, 6, cfg.d_model)).astype(np.float32)
    ref = np.asarray(jM.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), jcfg, capacity_factor=1.0,
                                num_groups=groups))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    y = tM.moe_ffn(tp, torch.from_numpy(x), cfg, capacity_factor=1.0,
                   num_groups=groups)
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5)
    with tM.grouped_routing(groups):
        y2 = tM.moe_ffn(tp, torch.from_numpy(x), cfg, capacity_factor=1.0)
    np.testing.assert_array_equal(y2.numpy(), y.numpy())
    assert all(m > MARGIN for m in margins), min(margins)
    if groups > 1:      # the grouping changes which pairs drop
        one = tM.moe_ffn(tp, torch.from_numpy(x), cfg, capacity_factor=1.0,
                         num_groups=1)
        assert float((one - y).abs().max()) > 1e-3


@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_dequantize_int8(axis):
    assert tOC.dequantize_int8 is tQ.dequantize_int8
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((5, 7)) * 3).astype(np.float32)
    jq, js = jQ.quantize_int8(jnp.asarray(x), axis=axis)
    ref = np.asarray(jQ.dequantize_int8(jq, js, axis=axis))
    tq, ts = tQ.quantize_int8(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    y = tQ.dequantize_int8(tq, ts, axis=axis)
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), ref)
    # the round trip is within half a step of each element's scale
    step = np.asarray(js) if axis is None else np.expand_dims(
        np.asarray(js), [d for d in range(2) if d != axis % 2])
    assert float(np.max(np.abs(y.numpy() - x) / step)) <= 0.5 + 1e-6


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_match_repro(arch):
    ref = jT.cache_axes(j_get_config(arch))
    got = tT.cache_axes(t_get_config(arch))
    assert got == [dict(g) for g in ref]
    assert len(got) == len(tT.layer_groups(t_get_config(arch)))


def _abstract_pair(jc, tc, ratio, env_kw):
    jr = jhost.abstract_plan(jc, budget_ratio=ratio,
                             env=jhost.CostEnv(**env_kw))
    tr = thost.abstract_plan(tc, budget_ratio=ratio,
                             env=thost.CostEnv(**env_kw),
                             latency_oracle=_jax_oracle_in_port())
    return jr, tr


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_units_spec_matches_repro(arch):
    jc, tc = j_get_config(arch).reduced(), t_get_config(arch).reduced()
    specs = 0
    for ratio in (0.6, 0.8):
        jr, tr = _abstract_pair(jc, tc, ratio,
                                dict(batch=2, seq=16, chips=1))
        assert (jr is None) == (tr is None)
        if jr is None:
            continue
        assert tr.plan.to_json() == jr.plan.to_json()
        spec = thost.plan_units_spec(tc, tr.plan)
        assert spec == jhost.plan_units_spec(jc, jr.plan)
        assert tr.speedup == jr.speedup
        # axes and the shapes of the params, allocating nothing
        jax_ax = jhost.compressed_model_axes(jc, spec)
        assert thost.compressed_model_axes(tc, spec) == jax_ax
        jp = jax.eval_shape(lambda: jhost.init_compressed_model(
            jc, spec, jax.random.PRNGKey(0)))
        tp = thost.init_compressed_model(tc, spec, device="meta")
        jflat = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_leaves_with_path(jp)}
        tflat = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_leaves_with_path(tp)}
        assert jflat.keys() == tflat.keys()
        for k, v in jflat.items():
            assert tuple(tflat[k].shape) == tuple(v.shape), k
            assert str(tflat[k].dtype).split(".")[-1] == str(v.dtype), k
            assert tflat[k].device.type == "meta"
        specs += 1
    assert specs > 0


def test_plan_units_spec_full_size_smollm():
    """SmolLM-135M at full size, the dry run's production env (256 chips):
    the same plan and units, the same predicted speedup."""
    jr, tr = _abstract_pair(j_get_config("smollm-135m"),
                            t_get_config("smollm-135m"), 0.6,
                            dict(batch=256, seq=4096, chips=256))
    assert tr.plan.to_json() == jr.plan.to_json()
    assert thost.plan_units_spec(t_get_config("smollm-135m"), tr.plan) == \
        jhost.plan_units_spec(j_get_config("smollm-135m"), jr.plan)
    assert tr.speedup == jr.speedup > 1.2


def test_forward_compressed_spec_matches_repro():
    """The production planning path without parameters, and the
    spec forward the dry run's ``--budget`` cells run, on the same numpy
    params in both packages."""
    jc = dataclasses.replace(j_get_config("smollm-135m").reduced(),
                             num_layers=4)
    tc = dataclasses.replace(t_get_config("smollm-135m").reduced(),
                             num_layers=4)
    jr, tr = _abstract_pair(jc, tc, 0.6, dict(batch=2, seq=16, chips=1))
    assert jr is not None and jr.speedup > 1.2
    spec = thost.plan_units_spec(tc, tr.plan)
    assert spec == jhost.plan_units_spec(jc, jr.plan)
    assert any(u[0] == "merged" for u in spec)
    rng = np.random.default_rng(11)
    shapes = jax.eval_shape(lambda: jhost.init_compressed_model(
        jc, spec, jax.random.PRNGKey(0)))
    params = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.1)
                          .astype(np.float32), shapes)
    batch = _batch(jc, 2, 8, seed=4)
    ref = np.asarray(jhost.forward_compressed_spec(
        jc, spec, jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}))
    tparams = jax.tree.map(torch.from_numpy, params)
    y = thost.forward_compressed_spec(
        tc, spec, tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tuple(y.shape) == (2, 8, tc.vocab_size)
    assert bool(torch.isfinite(y).all())
    _allclose(ref, y.numpy())
    # the spec's graph runs through the executor to the same logits
    graph = thost.spec_graph(tc, spec, tparams)
    _allclose(y.numpy(), trt.execute(graph, {
        k: torch.from_numpy(v) for k, v in batch.items()}, device="cpu"))
