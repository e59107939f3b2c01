"""The port's transformer rank-merge path against the JAX package's, on the
CPU.

Three fp32 configs at CI size (:func:`_torch_parity.lm_configs`: reduced
smollm, a 4-layer d 96 variant, and an ``attn``/``attn_local`` variant
whose 4-token ring buffer wraps during decode), with the same numpy
parameters (non-zero norm scales) in both packages:

* ``forward``, ``execute`` and ``decode_step`` give the same logits;
* the transformer host gives bit-identical latency columns under the JAX
  package's constants, and the same tables give bit-identical
  ``layermerge`` and ``depth`` plans;
* ``serve_loop`` gives the JAX loop's token ids on the same prompts;
* artifacts cross both ways with their fingerprints verified, and the
  CLI's artifact loads in the JAX package.

Tolerance on logits: max |Δ| ≤ 1e-5 · max |y| (fp32 sums in other orders;
merged factors through different SVDs, compared by what they compute).
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
from repro.models import transformer as jT
from repro.models import transformer_host as jhost
from repro.runtime import executor as jex
from repro.runtime import serving as jserving
from repro_torch import runtime as trt
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import dp as tdp
from repro_torch.core import latency as tlat
from repro_torch.core.compress import CompressResult
from repro_torch.core.tables import build_tables as t_build_tables
from repro_torch.models import transformer as tT
from repro_torch.models import transformer_host as thost
from repro_torch.runtime import serving as tserving

from _torch_parity import lm_configs, np_lm_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
CONFIGS = lm_configs()


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = float(np.abs(b).max()) + 1e-9
    assert float(np.abs(a - b).max()) <= RTOL * scale, \
        float(np.abs(a - b).max()) / scale


def _tokens(cfg, shape, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _jax_oracle_in_port():
    """The JAX package's roofline constants in the port's oracle (its ICI
    term is zero on one chip)."""
    return tlat.AnalyticOracle(peak_flops=jlat.PEAK_FLOPS_BF16,
                               hbm_bw=jlat.HBM_BW, op_overhead=1e-6)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    """Hosts of both packages on the same params, and the JAX package's
    feasible plans (``layermerge`` and ``depth``)."""
    name = request.param
    jc, tc = CONFIGS[name]
    params = np_lm_params(jc, seed=1)
    jh = jhost.TransformerHost(jc, jax.tree.map(jnp.asarray, params),
                               env=jhost.CostEnv(batch=2, seq=16))
    th = thost.TransformerHost(tc, tT.params_from_numpy(params),
                               env=thost.CostEnv(batch=2, seq=16),
                               device="cpu")
    results = []
    for method in ("layermerge", "depth"):
        for ratio in (0.5, 0.7, 0.9):
            r = jax_compress(jh, budget_ratio=ratio, P=100, method=method)
            if r is not None:
                results.append(r)
    return name, jh, th, results


def test_params_round_trip(setup):
    _, jh, th, _ = setup
    back = tT.params_to_numpy(th.params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jh.params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_forward_and_decode_match(setup):
    """Prefill logits, and decode logits at every position (past the
    ring buffer's wrap in the local config)."""
    name, jh, th, _ = setup
    jc, tc = jh.cfg, th.cfg
    toks = _tokens(jc, (2, 7))
    y = tT.forward(tc, th.params, {"tokens": torch.from_numpy(toks)})
    _close(y, jT.forward(jc, jh.params, {"tokens": jnp.asarray(toks)}))
    jcache, tcache = jT.init_cache(jc, 2, 7), tT.init_cache(tc, 2, 7, device="cpu")
    for t in range(7):
        lj, jcache = jT.decode_step(jc, jh.params, jcache,
                                    {"tokens": jnp.asarray(toks[:, t:t + 1])})
        lt, tcache = tT.decode_step(tc, th.params, tcache,
                                    {"tokens": torch.from_numpy(
                                        toks[:, t:t + 1])})
        _close(lt, lj)
    _close(lt[:, 0], y[:, -1])          # decode ends where prefill does


def test_tables_match_and_same_tables_give_same_plan(setup):
    _, jh, th, _ = setup
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
        assert tt.stats.num_latency_buckets == jt.stats.num_latency_buckets
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


def test_execute_matches_and_merging_is_exact(setup):
    name, jh, th, results = setup
    assert results
    toks = _tokens(jh.cfg, (2, 6))
    lowrank = 0
    for r in results:
        tgraph = th.lower_plan(r.plan)
        lowrank += trt.count_units(tgraph).get("lowrank", 0)
        y = trt.execute(tgraph, {"tokens": toks}, device="cpu")
        _close(y, jrt.execute(jh.lower_plan(r.plan),
                              {"tokens": jnp.asarray(toks)}))
        fn, p = th.replaced_apply(r.plan)
        _close(y, fn(p, {"tokens": toks}))
        mod = trt.GraphModule(tgraph)
        np.testing.assert_array_equal(
            mod({"tokens": torch.from_numpy(toks)}).numpy(), y.numpy())
    assert lowrank > 0, "no plan merged an FFN"


def test_compressed_decode_matches(setup):
    _, jh, th, results = setup
    r = max(results, key=lambda r: len(r.plan.segments))
    jg, tg = jh.lower_plan(r.plan), th.lower_plan(r.plan)
    toks = _tokens(jh.cfg, (3, 6), seed=4)
    jcache, tcache = jex.init_cache(jg, 3, 6), trt.init_cache(tg, 3, 6)
    for t in range(6):
        lj, jcache = jex.decode_step(jg, jcache,
                                     {"tokens": jnp.asarray(toks[:, t:t + 1])})
        lt, tcache = trt.decode_step(tg, tcache,
                                     {"tokens": torch.from_numpy(
                                         toks[:, t:t + 1])})
        _close(lt, lj)


def test_serve_loop_tokens_match(setup):
    _, jh, th, results = setup
    r = results[-1]
    jg, tg = jh.lower_plan(r.plan), th.lower_plan(r.plan)
    prompt = _tokens(jh.cfg, (2, 5), seed=5)
    step, params = jex.make_serve_step(jg)
    *_, jlogits, jseqs = jserving.serve_loop(
        step, params, jex.init_cache(jg, 2, 11), jnp.asarray(prompt), 6,
        warm=False)
    _, _, tlogits, tseqs = tserving.serve_loop(
        lambda c, t: trt.decode_step(tg, c, {"tokens": t}),
        lambda: trt.init_cache(tg, 2, 11), torch.from_numpy(prompt), 6)
    _close(tlogits, jlogits)
    np.testing.assert_array_equal(tseqs.numpy(), np.asarray(jseqs))


def _spec_and_arrays(path):
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    spec = json.loads(data.pop("__spec__").item())
    data.pop("__fingerprint__")
    return spec, data


def test_artifacts_cross_both_ways(setup, tmp_path):
    name, jh, th, results = setup
    res = results[-1]
    toks = _tokens(jh.cfg, (2, 5), seed=6)
    # JAX → port
    path = str(tmp_path / f"{name}.npz")
    fp = res.save(path)
    art = trt.load(path, device="cpu")
    assert art.fingerprint == fp
    assert trt.fingerprint(art.graph, art.plan, art.meta) == fp
    assert art.graph.meta["config"] == th.cfg
    _close(art.apply({"tokens": toks}),
           jrt.load(path).apply({"tokens": jnp.asarray(toks)}))
    # port → JAX
    tres = CompressResult(plan=res.plan, tables=None,
                          original_latency=res.original_latency,
                          compressed_latency=res.compressed_latency,
                          dp_seconds=0.0, host=th, params=th.params)
    tpath = str(tmp_path / f"{name}_port.npz")
    tfp = tres.save(tpath, extra_meta={"source": {"arch": name}})
    jart = jrt.load(tpath)
    assert jart.fingerprint == tfp
    assert jart.graph.meta["config"] == jh.cfg
    _close(trt.load(tpath, device="cpu").apply({"tokens": toks}),
           jart.apply({"tokens": jnp.asarray(toks)}))
    # the same plan lowered by each package publishes the same spec and
    # the same array keys, shapes and dtypes (values differ by the SVD)
    paths = [str(tmp_path / "j.npz"), str(tmp_path / "t.npz")]
    meta = {"source": {"arch": name}}
    jrt.save(paths[0], jh.lower_plan(res.plan), plan=res.plan, meta=meta)
    trt.save(paths[1], th.lower_plan(res.plan), plan=res.plan, meta=meta)
    (js, ja), (ts, ta) = (_spec_and_arrays(p) for p in paths)
    assert js == ts
    assert {k: (v.shape, v.dtype) for k, v in ja.items()} == \
        {k: (v.shape, v.dtype) for k, v in ta.items()}


def test_artifact_decode_api(tmp_path):
    jc, tc = CONFIGS["reduced"]
    th = thost.TransformerHost(tc, tT.params_from_numpy(np_lm_params(jc)),
                               env=thost.CostEnv(batch=2, seq=16),
                               device="cpu")
    from repro_torch.core.compress import compress
    res = compress(th, budget_ratio=0.9, method="depth", P=100)
    path = str(tmp_path / "a.npz")
    res.save(path)
    art = trt.load(path, device="cpu")
    toks = torch.from_numpy(_tokens(jc, (2, 4)))
    cache = art.init_cache(2, 4)
    for t in range(4):
        logits, cache = art.decode(cache, toks[:, t:t + 1])
    _close(logits[:, 0], art.apply({"tokens": toks})[:, -1])


def test_cli_artifact_loads_in_jax(tmp_path):
    out = str(tmp_path / "lm.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.compress", "--arch",
         "smollm-135m", "--device", "cpu", "--method", "depth",
         "--budget-ratio", "0.9", "--seq", "16", "--out", out],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert '"predicted_speedup"' in proc.stdout
    jart = jrt.load(out)
    tart = trt.load(out, device="cpu")
    assert jart.fingerprint == tart.fingerprint
    assert jart.meta["source"] == {"arch": "smollm-135m", "seed": 0,
                                   "family": "transformer", "reduced": True}
    assert trt.count_units(tart.graph).get("lowrank", 0) > 0
    toks = _tokens(jart.graph.meta["config"], (2, 5))
    _close(tart.apply({"tokens": toks}),
           jart.apply({"tokens": jnp.asarray(toks)}))


def test_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    from repro_torch.compress import main
    cfg = t_get_config("smollm-135m").reduced()
    for build in (lambda: tT.init_model(cfg),
                  lambda: tT.init_cache(cfg, 1, 4),
                  lambda: tserving.random_prompts(0, 1, 4, cfg.vocab_size)):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    params, _ = tT.init_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        thost.TransformerHost(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--arch", "smollm-135m", "--out", str(tmp_path / "b.npz")])
    assert not os.path.exists(tmp_path / "b.npz")


def test_what_is_not_ported_raises():
    """What the port still refuses, now that MoE, xLSTM, M-RoPE and every
    config id run: a bf16 config in the host (queue 3).  The MoE under a
    'model' axis larger than 1 runs: the expert-parallel path where the
    axis divides the experts (four ranks in ``tests/test_torch_mesh.py``
    and ``tests/test_torch_mesh_train.py``), the grouped path on whole
    expert weights where it does not or the rules set ``moe_shard_map``
    False — here the single device's function, bitwise."""
    import types

    from repro_torch.models import moe as tM
    cfg = t_get_config("granite-moe-1b-a400m").reduced()
    params, _ = tT.init_model(cfg, device="cpu")
    p = {k: v[0] for k, v in params["groups"][0]["ffn"].items()}
    x = torch.randn(2, 3, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    want = tM.moe_ffn(p, x, cfg, capacity_factor=cfg.capacity_factor)
    for model, flag in ((3, True), (2, False)):
        rules = types.SimpleNamespace(
            mesh=types.SimpleNamespace(shape={"data": 1, "model": model}),
            rules={"moe_shard_map": flag})
        got = tM.moe_dispatch(p, x, cfg, rules=rules,
                              capacity_factor=cfg.capacity_factor)
        assert torch.equal(got, want), (model, flag)
    with pytest.raises(ValueError, match="fp32"):
        thost.TransformerHost(dataclasses.replace(cfg, dtype="bfloat16"),
                              params, device="cpu")


def test_config_fields_are_the_reference_fields():
    """The config dict enters the artifact fingerprint."""
    from repro.configs import get_config as j_get_config
    from repro.configs import ARCH_IDS
    for arch in ARCH_IDS:
        assert dataclasses.asdict(t_get_config(arch)) == \
            dataclasses.asdict(j_get_config(arch))
    jc, tc = CONFIGS["local"]
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
