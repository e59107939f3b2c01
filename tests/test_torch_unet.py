"""The DDPM UNet at its full depth, narrow, against the JAX package's.

``zoo.ddpm_unet(in_hw=16, base=8)`` has the topology of the paper's
generation network (two down and two up levels, two concat skips, the
attention barrier at the middle, GN(8) after every conv but the output
conv, a 4-channel input), unlike ``tiny_unet`` (one level).  The same
numpy parameters and inputs go through ``repro`` (its plain reference
ops, as its own CPU tests run it) and ``repro_torch``:

* each layer's ℓ1 norm (the magnitude importance) agrees to 1e-5
  relative: fp32 sums of up to 9216 |w| in another order, whose rounding
  is of the order of sqrt(n)·2⁻²⁴ ≈ 6e-6;
* with ``repro``'s ℓ1 norms and analytic constants injected into the
  port's host, the enumerated spans, options and probes are equal, the
  latency and importance tables bit-identical, and ``compress`` gives
  the same plan, bit for bit, at two budgets;
* the lowered ``UnitGraph`` has the same unit kinds and statics
  (``concat_from``, ``gn_groups``, ...), and its params agree to 1e-6;
* ``execute`` agrees within 1e-5 · max|y| (and with ``apply_replaced``);
* an artifact written by either package loads in the other with the same
  sha256 fingerprint and outputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.core import compress as j_compress
from repro.core import latency as jlat
from repro.core.tables import build_tables as j_build_tables
from repro.core.tables import enumerate_probes as j_enumerate_probes
from repro.kernels.merged_conv import _VMEM_BUDGET
from repro.models import cnn as jcnn
from repro.models import cnn_host as jhost
from repro.models import zoo as jzoo
from repro_torch import runtime as trt
from repro_torch.core import compress as t_compress
from repro_torch.core import latency as tlat
from repro_torch.core.compress import CompressResult
from repro_torch.core.plan import LayerDesc as TLayerDesc
from repro_torch.core.tables import build_tables as t_build_tables
from repro_torch.core.tables import enumerate_probes as t_enumerate_probes
from repro_torch.models import cnn as tcnn
from repro_torch.models import cnn_host as thost
from repro_torch.models import zoo as tzoo
from repro_torch.runtime.artifact import flatten_tree

from _torch_parity import np_params

UNET = dict(in_hw=16, base=8)
BUDGETS = (0.6, 0.8)
RTOL = 1e-5


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = float(np.abs(b).max()) + 1e-9
    assert float(np.abs(a - b).max()) <= rtol * scale, \
        float(np.abs(a - b).max()) / scale


def _jax_oracle_in_port():
    return tlat.AnalyticOracle(peak_flops=jlat.PEAK_FLOPS_BF16,
                               hbm_bw=jlat.HBM_BW, op_overhead=1e-6)


@pytest.fixture(scope="module")
def unet():
    jnet, tnet = jzoo.ddpm_unet(**UNET), tzoo.ddpm_unet(**UNET)
    assert repr(jnet).replace("repro.", "") == repr(tnet).replace(
        "repro_torch.", "")
    params = np_params(jnet, seed=5)
    # the costs of repro's tiled model and byte width, as the parity
    # tests of the core price them
    jh = jhost.CNNHost(jnet, jax.tree.map(jnp.asarray, params), batch=2)
    th = thost.CNNHost(tnet, tcnn.params_from_numpy(params, "cpu"), batch=2,
                       dtype_bytes=2, tile_budget=_VMEM_BUDGET, device="cpu")
    # repro's ℓ1 norms in the port's host: the tables then see the same
    # inputs, and must come out bit for bit
    th._descs = [TLayerDesc(**dataclasses.asdict(d)) for d in jh.descs()]
    x = np.random.default_rng(9).standard_normal(
        (2, 16, 16, 4)).astype(np.float32)
    jres = {r: j_compress(jh, budget_ratio=r, P=100,
                          latency_oracle=jlat.AnalyticTPUOracle())
            for r in BUDGETS}
    tres = {r: t_compress(th, budget_ratio=r, P=100,
                          latency_oracle=_jax_oracle_in_port())
            for r in BUDGETS}
    return jh, th, x, jres, tres


def test_the_narrow_unet_has_the_ddpm_topology(unet):
    _, th, *_ = unet
    net = th.net
    kinds = [s.kind for s in net.specs]
    assert net.L == 17 and kinds.count("upsample") == 2
    assert kinds.count("attn") == 1 and len(net.skips) == 2
    assert net.boundary_shapes()[11][2] == 32 + 16     # the deep concat


def test_l1_norms_agree(unet):
    jh, th, *_ = unet
    mine = th.net.layer_descs(th.params)
    assert [d.value for d in mine] == pytest.approx(
        [d.value for d in jh.descs()], rel=1e-5)
    assert [dataclasses.replace(d, value=0.0) for d in mine] == \
        [dataclasses.replace(d, value=0.0) for d in th.descs()]


@pytest.mark.parametrize("method", ["layermerge", "depth"])
def test_enumerated_segments_are_equal(unet, method):
    jh, th, *_ = unet
    assert list(th.enumerator(method).all_spans()) == \
        list(jh.enumerator(method).all_spans())
    tp = t_enumerate_probes(th, method)
    jp = j_enumerate_probes(jh, method)
    assert [p[:5] for p in tp] == [p[:5] for p in jp]
    assert [dataclasses.asdict(p[5]) for p in tp] == \
        [dataclasses.asdict(p[5]) for p in jp]


def test_tables_are_bit_identical(unet):
    jh, th, *_ = unet
    jt = j_build_tables(jh, latency_oracle=jlat.AnalyticTPUOracle())
    tt = t_build_tables(th, latency_oracle=_jax_oracle_in_port())
    assert tt.entries.keys() == jt.entries.keys()
    for span, row in jt.entries.items():
        assert tt.entries[span].keys() == row.keys(), span
        for k, (imp, lat, kept) in row.items():
            timp, tlat_, tkept = tt.entries[span][k]
            assert tlat_ == lat, (span, k)             # bit-identical
            assert tkept == kept
            assert timp == imp
    assert tt.num_pruned == jt.num_pruned
    assert tt.stats.num_latency_buckets == jt.stats.num_latency_buckets
    for *_, seg in t_enumerate_probes(th):
        assert th.probe_signature(seg) == jh.probe_signature(seg)


@pytest.mark.parametrize("ratio", BUDGETS)
def test_plans_are_identical(unet, ratio):
    *_, jres, tres = unet
    j, t = jres[ratio], tres[ratio]
    assert j is not None and t is not None
    assert t.plan.to_json() == j.plan.to_json()
    assert t.original_latency == j.original_latency
    assert t.compressed_latency == j.compressed_latency


def _unit_statics(u):
    return {k: v for k, v in vars(u).items() if k not in ("params",)}


@pytest.mark.parametrize("ratio", BUDGETS)
def test_lowered_graphs_are_equal(unet, ratio):
    jh, th, _, jres, _ = unet
    plan = jres[ratio].plan
    jg, tg = jh.lower_plan(plan), th.lower_plan(plan)
    assert [u.kind for u in tg.units] == [u.kind for u in jg.units]
    assert tg.meta == jg.meta
    for tu, ju in zip(tg.units, jg.units):
        assert _unit_statics(tu) == _unit_statics(ju)
        tp, jp = flatten_tree(tu.params), jax.tree_util.tree_flatten_with_path(
            ju.params)[0]
        jp = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
              for path, leaf in jp}
        assert tp.keys() == jp.keys()
        for key, leaf in tp.items():
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jp[key]),
                                       rtol=1e-6, atol=1e-6, err_msg=key)
    kinds = {u.kind for u in tg.units}
    assert {"upsample", "attn", "conv"} <= kinds
    assert any(u.concat_from is not None for u in tg.units
               if u.kind == "upsample")
    assert any("gn" in u.params for u in tg.units if u.kind == "conv")


@pytest.mark.parametrize("ratio", BUDGETS)
def test_execute_matches(unet, ratio):
    jh, th, x, jres, _ = unet
    plan = jres[ratio].plan
    y = trt.execute(th.lower_plan(plan), x, device="cpu")
    _close(y, jrt.execute(jh.lower_plan(plan), jnp.asarray(x)))
    y_rep = tcnn.apply_replaced(th.net, th.params, torch.from_numpy(x), plan)
    _close(y, y_rep)
    _close(y_rep, jcnn.apply_replaced(jh.net, jh.params, jnp.asarray(x),
                                      plan))
    assert tuple(y.shape) == (2, 16, 16, 3)


def test_artifacts_cross_both_ways(unet, tmp_path):
    jh, th, x, jres, _ = unet
    res = jres[BUDGETS[0]]
    path = str(tmp_path / "j.npz")
    fp = res.save(path)
    art = trt.load(path, device="cpu")
    assert art.fingerprint == fp
    assert trt.fingerprint(art.graph, art.plan, art.meta) == fp
    y = art.apply(x)
    _close(y, jrt.load(path).apply(jnp.asarray(x)))
    tres = CompressResult(plan=res.plan, tables=None,
                          original_latency=res.original_latency,
                          compressed_latency=res.compressed_latency,
                          dp_seconds=0.0, host=th, params=th.params)
    tpath = str(tmp_path / "t.npz")
    tfp = tres.save(tpath, extra_meta={"source": {"arch": "ddpm_unet"}})
    jart = jrt.load(tpath)
    assert jart.fingerprint == tfp
    assert jart.plan.to_json() == res.plan.to_json()
    _close(trt.load(tpath, device="cpu").apply(x),
           jart.apply(jnp.asarray(x)))
