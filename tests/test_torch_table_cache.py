"""The port's table cache against the JAX package's, on the CPU.

Counterparts of the cache cases of ``tests/test_probe_engine.py`` (a hit,
served across engines, a miss on a parameter, oracle or method change,
no cache for an unnamed importance, a torn file read as a miss), and the
parity of the two packages' caches on the same numpy inputs:

* a cache file written by either package loads in the other with equal
  ``entries``, ``num_pruned`` and ``provenance`` (precision siblings'
  ``(k, mode)`` keys too);
* journal lines are byte-identical for the same records;
* ``pytree_digest``, ``machine_token`` on the CPU, ``importance_token``
  and ``oracle_token`` give the JAX package's strings for the same
  inputs.

Tables are compared exactly (``==``): the cache stores JSON, which
round-trips every double.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import importance as jimp
from repro.core import latency as jlat
from repro.core import table_cache as jcache
from repro.core.tables import build_tables as j_build_tables
from repro.kernels.merged_conv import _VMEM_BUDGET
from repro.models import cnn_host as jhost
from repro.models import zoo as jzoo
from repro_torch.checkpoint import ckpt
from repro_torch.core import (AnalyticOracle, WallClockOracle, build_tables,
                              enumerate_probes)
from repro_torch.core import importance as timp
from repro_torch.core import latency as tlat
from repro_torch.core import table_cache
from repro_torch.models import cnn as tcnn
from repro_torch.models import cnn_host as thost
from repro_torch.models import transformer as tT
from repro_torch.models import transformer_host as tthost
from repro_torch.models import zoo as tzoo

from _torch_parity import lm_configs, np_lm_params, np_params

TINY = dict(num_classes=4, in_hw=8, width=4, blocks=(2,))


def _host(seed=0, **kw):
    net = tzoo.tiny_resnet(**TINY)
    params = tcnn.params_from_numpy(np_params(jzoo.tiny_resnet(**TINY),
                                              seed), "cpu")
    return thost.CNNHost(net, params, batch=4, device="cpu", **kw)


def _hosts(seed=0):
    """The JAX package's host and the port's on the same numpy params,
    the port's priced with the JAX package's cost model."""
    params = np_params(jzoo.tiny_resnet(**TINY), seed)
    jh = jhost.CNNHost(jzoo.tiny_resnet(**TINY),
                       jax.tree.map(jnp.asarray, params), batch=4)
    th = thost.CNNHost(tzoo.tiny_resnet(**TINY),
                       tcnn.params_from_numpy(params, "cpu"), batch=4,
                       dtype_bytes=2, tile_budget=_VMEM_BUDGET, device="cpu")
    return jh, th, params


@pytest.fixture(scope="module")
def host():
    return _host()


# ---------------------------------------------------------------------------
# Counterparts of the reference's cache tests
# ---------------------------------------------------------------------------

def test_cache_roundtrip_hit(host, tmp_path):
    cold = build_tables(host, engine="batched", cache_dir=str(tmp_path))
    warm = build_tables(host, engine="batched", cache_dir=str(tmp_path))
    assert not cold.stats.cache_hit and warm.stats.cache_hit
    assert warm.entries == cold.entries
    assert warm.num_pruned == cold.num_pruned


def test_cache_serves_across_engines(host, tmp_path):
    cold = build_tables(host, engine="sequential", cache_dir=str(tmp_path))
    warm = build_tables(host, engine="batched", cache_dir=str(tmp_path))
    assert warm.stats.cache_hit
    assert warm.entries == cold.entries


def test_cache_miss_on_param_and_oracle_change(tmp_path):
    build_tables(_host(0), cache_dir=str(tmp_path))
    t1 = build_tables(_host(1), cache_dir=str(tmp_path))
    assert not t1.stats.cache_hit          # other parameter values
    t2 = build_tables(_host(0), cache_dir=str(tmp_path),
                      latency_oracle=AnalyticOracle(op_overhead=2e-6))
    assert not t2.stats.cache_hit          # the oracle is in the key
    t3 = build_tables(_host(0), cache_dir=str(tmp_path), method="depth")
    assert not t3.stats.cache_hit          # the method is in the key
    t4 = build_tables(_host(0, tile_budget=_VMEM_BUDGET),
                      cache_dir=str(tmp_path))
    assert not t4.stats.cache_hit          # the cost model is in the key
    assert build_tables(_host(0), cache_dir=str(tmp_path)).stats.cache_hit


def test_cache_disabled_for_unnamed_importance(host):
    x = torch.zeros(2, 8, 8, 3)
    spec = timp.ImportanceSpec(timp.xent_loss, timp.accuracy_perf,
                               [(x, torch.zeros(2).long())], [], steps=2)
    assert table_cache.cache_key(host, AnalyticOracle(), "layermerge",
                                 spec) is None
    named = dataclasses.replace(spec, cache_token="toy-v1")
    key = table_cache.cache_key(host, AnalyticOracle(), "layermerge", named)
    assert key is not None
    assert key != table_cache.cache_key(
        host, AnalyticOracle(), "layermerge",
        dataclasses.replace(named, steps=3))   # hyperparameters count


def test_cache_torn_file_is_miss(host, tmp_path):
    build_tables(host, cache_dir=str(tmp_path))
    key = table_cache.cache_key(host, AnalyticOracle(), "layermerge",
                                "magnitude")
    path = tmp_path / f"tables_{key}.json"
    path.write_text(path.read_text()[:40])     # torn write
    again = build_tables(host, cache_dir=str(tmp_path))
    assert not again.stats.cache_hit            # corrupt entry: rebuild
    healed = build_tables(host, cache_dir=str(tmp_path))
    assert healed.stats.cache_hit               # the rebuild re-published


def test_stale_format_is_a_plain_miss(host, tmp_path):
    build_tables(host, cache_dir=str(tmp_path))
    key = table_cache.cache_key(host, AnalyticOracle(), "layermerge",
                                "magnitude")
    path = tmp_path / f"tables_{key}.json"
    payload = json.loads(path.read_text())
    payload["format"] = table_cache.FORMAT_VERSION - 1
    path.write_text(json.dumps(payload))
    assert table_cache.load(str(tmp_path), key) is None
    assert path.exists()                        # valid, so not quarantined


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------

def test_fingerprint_reads_structure_workload_and_params():
    a = _host(0)
    assert a.fingerprint() == _host(0).fingerprint()
    assert _host(1).fingerprint() != a.fingerprint()
    for field, value in (("batch", 2), ("dtype_bytes", 2),
                         ("max_span", 2), ("w_bytes", 1),
                         ("tile_budget", _VMEM_BUDGET)):
        b = _host(0)
        setattr(b, field, value)
        assert b.fingerprint() != a.fingerprint(), field


def test_transformer_fingerprint_and_segment_callable():
    jc, tc = lm_configs()["reduced"]
    params = tT.params_from_numpy(np_lm_params(jc))
    env = tthost.CostEnv(batch=2, seq=8)
    a = tthost.TransformerHost(tc, params, env=env, device="cpu")
    assert a.fingerprint() == tthost.TransformerHost(
        tc, params, env=env, device="cpu").fingerprint()
    assert a.fingerprint() != tthost.TransformerHost(
        tc, params, env=tthost.CostEnv(batch=4, seq=8),
        device="cpu").fingerprint()
    for *_, seg in enumerate_probes(a)[:4]:
        assert torch.equal(a.segment_callable(seg)(),
                           a.segment_probe(seg)())


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

def _same_tables(a, b):
    assert a.entries == b.entries
    assert a.num_pruned == b.num_pruned
    assert a.provenance == b.provenance


@pytest.mark.parametrize("quantize", [None, "w8a8"])
def test_reference_cache_file_loads_in_port(tmp_path, quantize):
    jh, th, _ = _hosts()
    jt = j_build_tables(jh, latency_oracle=jlat.AnalyticTPUOracle(),
                        quantize=quantize)
    (i, j), row = next(iter(jt.entries.items()))
    jt = dataclasses.replace(jt, provenance={(i, j, min(
        k for k in row if not isinstance(k, tuple))): "quarantined"})
    jcache.save(str(tmp_path), "k", jt)
    tt = table_cache.load(str(tmp_path), "k")
    assert tt is not None and tt.stats.cache_hit
    _same_tables(tt, jt)
    assert tt.stats.as_dict() == {**jt.stats.as_dict(), "cache_hit": True}


@pytest.mark.parametrize("quantize", [None, "w8a8"])
def test_port_cache_file_loads_in_reference(tmp_path, quantize):
    _, th, _ = _hosts()
    tt = build_tables(th, latency_oracle=AnalyticOracle(), quantize=quantize,
                      ratio_oracle=AnalyticOracle())
    (i, j), row = next(iter(tt.entries.items()))
    tt = dataclasses.replace(
        tt, provenance={(i, j, min(k for k in row
                                   if not isinstance(k, tuple))): "retimed"},
        timings={"('conv', 8)": (1.5e-5, "measured"),
                 "('conv', 4)": (None, "quarantined")})
    table_cache.save(str(tmp_path), "k", tt)
    jt = jcache.load(str(tmp_path), "k")        # ignores "timings"
    assert jt is not None and jt.stats.cache_hit
    _same_tables(jt, tt)
    back = table_cache.load(str(tmp_path), "k")
    _same_tables(back, tt)
    assert back.timings == tt.timings


def test_journal_lines_byte_identical(tmp_path):
    records = [("latb:('conv', 8, 8, 4)", 1.25e-05, "measured"),
               ("latb:('pool', 3)", None, "quarantined"),
               ("imp:0:2:3", 0.7312345678901234, "measured"),
               ("latb:('conv', 4)", 3.0000000000000004e-06, "retimed")]
    jj = jcache.BuildJournal(str(tmp_path / "j"), "key")
    tj = table_cache.BuildJournal(str(tmp_path / "t"), "key")
    for k, v, p in records:
        jj.put(k, v, p)
        tj.put(k, v, p)
    assert (tmp_path / "t" / "tables_key.journal").read_bytes() == \
        (tmp_path / "j" / "tables_key.journal").read_bytes()
    jckpt.append_journal_line(str(tmp_path / "a"), '{"k": "x"}\n')
    ckpt.append_journal_line(str(tmp_path / "b"), '{"k": "x"}\n')
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    again = table_cache.BuildJournal(str(tmp_path / "j"), "key")
    assert len(again) == len(records)
    for k, v, p in records:
        assert again.get(k) == (v, p)
    many = table_cache.BuildJournal(str(tmp_path / "m"), "key")
    assert many.put_many(records) == len(records)
    assert many.put_many(records[:2]) == 0     # already journaled
    assert (tmp_path / "m" / "tables_key.journal").read_bytes() == \
        (tmp_path / "t" / "tables_key.journal").read_bytes()


def test_tokens_match_the_reference():
    for kw in ({}, dict(warmup=2, iters=7, groups=3)):
        assert tlat.oracle_token(WallClockOracle(**kw)) == \
            jcache.oracle_token(jlat.WallClockOracle(**kw))
    assert table_cache.oracle_token is tlat.oracle_token
    x = np.zeros((2, 8, 8, 3), np.float32)
    for kw in (dict(cache_token="toy-v1"),
               dict(cache_token="toy-v2", steps=3, lr=3e-3,
                    normalize_by_base=True)):
        js = jimp.ImportanceSpec(jimp.xent_loss, jimp.accuracy_perf,
                                 [jnp.asarray(x)], [], **kw)
        ts = timp.ImportanceSpec(timp.xent_loss, timp.accuracy_perf,
                                 [torch.from_numpy(x)], [], **kw)
        assert table_cache.importance_token(ts) == \
            jcache.importance_token(js)
    assert table_cache.importance_token("magnitude") == "magnitude"
    assert table_cache.importance_token(dataclasses.replace(
        ts, cache_token=None)) is None


def test_pytree_digest_and_machine_token_match_the_reference():
    _, _, params = _hosts()
    tparams = tcnn.params_from_numpy(params, "cpu")
    assert table_cache.pytree_digest(tparams) == \
        jcache.pytree_digest(jax.tree.map(jnp.asarray, params))
    tparams["layers"][0]["w"] = tparams["layers"][0]["w"] + 1e-7
    assert table_cache.pytree_digest(tparams) != \
        jcache.pytree_digest(jax.tree.map(jnp.asarray, params))
    assert table_cache.machine_token("cpu") == jcache.machine_token()
    assert table_cache.machine_token("cpu").endswith("|cpu|cpu")


def test_quarantine_keeps_earlier_evidence(tmp_path):
    p = tmp_path / "f.json"
    for n in range(3):
        p.write_text(str(n))
        assert table_cache.quarantine(str(p)) == str(p) + (
            ".corrupt" if n == 0 else f".corrupt.{n}")
    assert not p.exists()
    assert table_cache.quarantine(str(p)) is None
    assert [(tmp_path / f).read_text() for f in
            ("f.json.corrupt", "f.json.corrupt.1", "f.json.corrupt.2")] == \
        ["0", "1", "2"]
