"""The port's crash-safe table build against the JAX package's, on the CPU.

Counterparts of the table-build cases of ``tests/test_faults.py``:

* the journal survives torn appends and heals the file; a garbled
  record is skipped;
* a build killed mid-bucket, mid-journal-write or mid-publish resumes
  bitwise equal to an uninterrupted build, under either engine, and so
  do the Eq. 4 importance probes; ``resume=False`` starts over; a cache
  hit removes a stale journal;
* a flaky probe retries, a straggler over its budget retries, a bucket
  that keeps failing gets the analytic estimate with its provenance
  through the cache and the artifact, ``quarantine=False`` raises, and a
  noisy timing is taken again;
* a corrupt cache file and a corrupt artifact are quarantined;
* the kill-and-resume smoke crashes a real child process.

The CPU cannot time (the port's ``WallClockOracle`` refuses it), so the
wall-clock cases run a test-only subclass whose ``time_callable_stats``
runs the probe on the CPU and returns seconds from a counted or seeded
sequence; the library code is what runs on the card.

Parity with the JAX package: under the analytic oracle with the JAX
package's constants injected, a resumed build's latency column is
bitwise ``repro``'s and its plan ``repro``'s (importances to 1e-6
relative: the magnitude proxy sums the same weights in another order).
And the one-timing rule: with a noisy stub timer, a cache hit and a
resume give the plan and ``T_orig`` of the first build, bitwise.
"""
import dataclasses
import json
import os
import random

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import compress as j_compress
from repro.core import latency as jlat
from repro.core.tables import build_tables as j_build_tables
from repro.kernels.merged_conv import _VMEM_BUDGET
from repro.models import cnn_host as jhost
from repro.models import zoo as jzoo
from repro.testing import faults as jfaults
from repro_torch import runtime
from repro_torch.checkpoint import ckpt
from repro_torch.core import (AnalyticOracle, ImportanceSpec, ProbeConfig,
                              Segment, WallClockOracle, accuracy_perf,
                              build_tables, compress, enumerate_probes,
                              layer_latencies, table_cache, xent_loss)
from repro_torch.core import probe_engine
from repro_torch.core.probe_engine import (PROBE_MEASURED, PROBE_QUARANTINED,
                                           PROBE_RETIMED, ProbeCallable)
from repro_torch.models import cnn as tcnn
from repro_torch.models import cnn_host as thost
from repro_torch.models import zoo as tzoo
from repro_torch.testing import faults

from _torch_parity import np_params

TINY = dict(num_classes=4, in_hw=8, width=4, blocks=(2,))


@pytest.fixture(scope="module")
def host():
    net = tzoo.tiny_resnet(**TINY)
    params = tcnn.params_from_numpy(np_params(jzoo.tiny_resnet(**TINY)),
                                    "cpu")
    return thost.CNNHost(net, params, batch=4, device="cpu")


@pytest.fixture(scope="module")
def reference(host):
    """The uninterrupted analytic build every resume must reproduce."""
    return build_tables(host)


def _fast_probe(**kw):
    return ProbeConfig(backoff_s=0.0, **kw)


@dataclasses.dataclass
class _StubOracle(WallClockOracle):
    """The card's timing, stubbed for the CPU: runs the probe once and
    returns 1 ms plus a microsecond per timing so far (distinct values,
    no clock read)."""

    def time_callable_stats(self, fn, *, warmup=None):
        fn()
        n = self.__dict__["_n"] = self.__dict__.get("_n", 0) + 1
        return 1e-3 + 1e-6 * n, 0.0


@dataclasses.dataclass
class _IdleOracle(WallClockOracle):
    """A stub timing that does no work: whatever the scheduler does to
    this process, a timing takes microseconds."""

    def time_callable_stats(self, fn, *, warmup=None):
        return 1e-3, 0.0


@dataclasses.dataclass
class _NoisyOracle(WallClockOracle):
    """Seconds drawn from a seeded stream (``rng``, not a field: two
    oracles of different seeds share a cache key), as two card timings of
    one shape differ."""

    def time_callable_stats(self, fn, *, warmup=None):
        return 1e-3 * (1.0 + 0.5 * self.rng.random()), 0.0


def _noisy(seed):
    ora = _NoisyOracle()
    ora.rng = random.Random(seed)
    return ora


@dataclasses.dataclass
class _SpikyOracle(_StubOracle):
    """Its first timing reports an outlier spread, later ones are calm."""

    def time_callable_stats(self, fn, *, warmup=None):
        med, _ = super().time_callable_stats(fn, warmup=warmup)
        return med, (10.0 if self.__dict__["_n"] == 1 else 0.0)


# ---------------------------------------------------------------------------
# Journal primitives
# ---------------------------------------------------------------------------

def test_journal_roundtrip_and_torn_tail(tmp_path):
    path = str(tmp_path / "j.journal")
    ckpt.append_journal_line(path, json.dumps({"k": "a", "v": 1.5}))
    ckpt.append_journal_line(path, json.dumps({"k": "b", "v": 2.5}))
    with open(path, "ab") as f:                # crash mid-append: torn tail
        f.write(b'{"k": "c", "v"')
    lines = ckpt.read_journal_lines(path)
    assert [json.loads(line)["k"] for line in lines] == ["a", "b"]
    raw = open(path, "rb").read()              # the reader healed the file
    assert raw.endswith(b"\n") and raw.count(b"\n") == 2
    ckpt.append_journal_line(path, json.dumps({"k": "c", "v": 3.5}))
    assert len(ckpt.read_journal_lines(path)) == 3
    assert ckpt.read_journal_lines(str(tmp_path / "missing")) == []


def test_journal_torn_write_injection(tmp_path):
    path = str(tmp_path / "j.journal")
    ckpt.append_journal_line(path, json.dumps({"k": "a", "v": 1.0}))
    with faults.inject(faults.Fault("journal.append", "torn", nth=1,
                                    keep_bytes=5)):
        with pytest.raises(faults.FaultKill):
            ckpt.append_journal_line(path, json.dumps({"k": "b", "v": 2.0}))
    lines = ckpt.read_journal_lines(path)
    assert [json.loads(line)["k"] for line in lines] == ["a"]
    ckpt.append_journal_line(path, json.dumps({"k": "b", "v": 2.0}))
    assert len(ckpt.read_journal_lines(path)) == 2


def test_garbled_journal_record_is_skipped(tmp_path):
    j = table_cache.BuildJournal(str(tmp_path), "k")
    j.put("latb:a", 1.0)
    with faults.inject(faults.Fault("journal.append", "garble")):
        j.put("latb:b", 2.0)                   # lands complete, unparsable
    j.put("latb:c", 3.0)
    again = table_cache.BuildJournal(str(tmp_path), "k")
    assert (again.get("latb:a"), again.get("latb:b"), again.get("latb:c")) \
        == ((1.0, "measured"), None, (3.0, "measured"))


def test_atomic_writes(tmp_path):
    p = str(tmp_path / "d" / "f.txt")
    ckpt.atomic_write_text(p, "one")
    ckpt.atomic_write_bytes(p, b"two")
    assert open(p, "rb").read() == b"two"
    assert os.listdir(tmp_path / "d") == ["f.txt"]   # no .tmp left


# ---------------------------------------------------------------------------
# Resumable builds: bitwise equal after any injected crash
# ---------------------------------------------------------------------------

def _crash_then_resume(host, reference, cache_dir, rule, **kw):
    with faults.inject(rule):
        with pytest.raises(faults.FaultKill):
            build_tables(host, cache_dir=cache_dir, **kw)
    resumed = build_tables(host, cache_dir=cache_dir, **kw)
    assert resumed.entries == reference.entries
    assert resumed.num_pruned == reference.num_pruned
    return resumed


def test_kill_mid_bucket_resumes_bit_identical(host, reference, tmp_path):
    resumed = _crash_then_resume(
        host, reference, str(tmp_path),
        faults.Fault("tables.bucket", "kill", nth=3))
    assert resumed.stats.num_journal_hits >= 2
    assert not list(tmp_path.glob("*.journal"))    # discarded after publish


def test_kill_mid_journal_write_resumes_bit_identical(host, reference,
                                                      tmp_path):
    """The torn record is lost (probed again); buckets 1-3 replay."""
    resumed = _crash_then_resume(
        host, reference, str(tmp_path),
        faults.Fault("journal.append", "torn", nth=4))
    assert resumed.stats.num_journal_hits == 3


def test_kill_mid_publish_resumes_bit_identical(host, reference, tmp_path):
    """Every bucket journaled, the tables not published: the resume
    replays the whole build."""
    resumed = _crash_then_resume(
        host, reference, str(tmp_path),
        faults.Fault("table_cache.publish", "kill"))
    assert resumed.stats.num_journal_hits == resumed.stats.num_latency_buckets


def test_no_resume_discards_journal(host, reference, tmp_path):
    with faults.inject(faults.Fault("tables.bucket", "kill", nth=3)):
        with pytest.raises(faults.FaultKill):
            build_tables(host, cache_dir=str(tmp_path))
    fresh = build_tables(host, cache_dir=str(tmp_path), resume=False)
    assert fresh.stats.num_journal_hits == 0
    assert fresh.entries == reference.entries


def test_cache_hit_cleans_stale_journal(host, tmp_path):
    built = build_tables(host, cache_dir=str(tmp_path))
    key = table_cache.cache_key(host, AnalyticOracle(), "layermerge",
                                "magnitude")
    with open(table_cache.journal_path(str(tmp_path), key), "w") as f:
        f.write('{"k": "stale", "v": 1.0, "p": "measured"}\n')
    warm = build_tables(host, cache_dir=str(tmp_path))
    assert warm.stats.cache_hit and warm.entries == built.entries
    assert not os.path.exists(table_cache.journal_path(str(tmp_path), key))


def test_sequential_engine_resumes_too(host, tmp_path):
    ref = build_tables(host, engine="sequential")
    with faults.inject(faults.Fault("tables.bucket", "kill", nth=5)):
        with pytest.raises(faults.FaultKill):
            build_tables(host, engine="sequential", cache_dir=str(tmp_path))
    resumed = build_tables(host, engine="sequential",
                           cache_dir=str(tmp_path))
    assert resumed.entries == ref.entries
    assert resumed.stats.num_journal_hits >= 4


@pytest.mark.parametrize("nth", [1, 2])
def test_importance_probes_resume(tmp_path, nth):
    """Measured-importance builds journal per probe and resume without
    tuning completed span groups again; a partly journaled span batch
    reruns whole, so the column is bitwise the uninterrupted one."""
    net = tzoo.tiny_resnet(num_classes=4, in_hw=8, width=4, blocks=(1,))
    params = tcnn.params_from_numpy(np_params(jzoo.tiny_resnet(
        num_classes=4, in_hw=8, width=4, blocks=(1,))), "cpu")
    h = thost.CNNHost(net, params, batch=4, device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, 8, 8, 3, generator=g)
    y = torch.randint(0, 4, (8,), generator=g)
    spec = ImportanceSpec(loss_fn=xent_loss, perf_fn=accuracy_perf,
                          train_batches=[(x, y)], eval_batches=[(x, y)],
                          steps=2, lr=1e-3, cache_token="faults-v1")
    base = accuracy_perf(lambda p, xx: tcnn.apply_replaced(net, p, xx),
                         params, spec.eval_batches)
    ref = build_tables(h, importance=spec, base_perf=base)
    assert ref.stats.num_importance_batches > 0
    with faults.inject(faults.Fault("tables.importance", "kill", nth=nth)):
        with pytest.raises(faults.FaultKill):
            build_tables(h, importance=spec, base_perf=base,
                         cache_dir=str(tmp_path))
    resumed = build_tables(h, importance=spec, base_perf=base,
                           cache_dir=str(tmp_path))
    assert resumed.entries == ref.entries
    assert resumed.stats.num_journal_hits > 0
    assert build_tables(h, importance=spec, base_perf=base,
                        cache_dir=str(tmp_path)).stats.cache_hit


# ---------------------------------------------------------------------------
# Parity with the JAX package under its analytic constants
# ---------------------------------------------------------------------------

def _jax_oracle_in_port():
    return AnalyticOracle(peak_flops=jlat.PEAK_FLOPS_BF16,
                          hbm_bw=jlat.HBM_BW, op_overhead=1e-6)


@pytest.mark.parametrize("rule", [
    ("tables.bucket", "kill", 3), ("journal.append", "torn", 4),
    ("table_cache.publish", "kill", 1)])
def test_resumed_build_and_plan_match_the_reference(tmp_path, rule):
    params = np_params(jzoo.tiny_resnet(**TINY))
    jh = jhost.CNNHost(jzoo.tiny_resnet(**TINY),
                       jax.tree.map(jnp.asarray, params), batch=4)
    th = thost.CNNHost(tzoo.tiny_resnet(**TINY),
                       tcnn.params_from_numpy(params, "cpu"), batch=4,
                       dtype_bytes=2, tile_budget=_VMEM_BUDGET, device="cpu")
    point, action, nth = rule
    kw = dict(latency_oracle=_jax_oracle_in_port(), cache_dir=str(tmp_path))
    with faults.inject(faults.Fault(point, action, nth=nth)):
        with pytest.raises(faults.FaultKill):
            compress(th, budget_ratio=0.6, P=200, **kw)
    with jfaults.inject(jfaults.Fault(point, action, nth=nth)):
        with pytest.raises(jfaults.FaultKill):
            j_build_tables(jh, cache_dir=str(tmp_path / "jax"))
    jt = j_build_tables(jh, cache_dir=str(tmp_path / "jax"))
    tr = compress(th, budget_ratio=0.6, P=200, **kw)
    assert tr.tables.stats.num_journal_hits == jt.stats.num_journal_hits > 0
    assert tr.tables.entries.keys() == jt.entries.keys()
    for span, row in jt.entries.items():
        assert tr.tables.entries[span].keys() == row.keys()
        for k, (imp, lat, kept) in row.items():
            t_imp, t_lat, t_kept = tr.tables.entries[span][k]
            assert (t_lat, t_kept) == (lat, kept)     # bitwise
            assert t_imp == pytest.approx(imp, rel=1e-6)
    assert tr.tables.num_pruned == jt.num_pruned
    jr = j_compress(jh, budget_ratio=0.6, P=200,
                    latency_oracle=jlat.AnalyticTPUOracle())
    tp, jp = json.loads(tr.plan.to_json()), json.loads(jr.plan.to_json())
    assert tp.pop("objective") == pytest.approx(jp.pop("objective"),
                                                rel=1e-6)
    assert tp == jp
    assert tr.original_latency == jr.original_latency


# ---------------------------------------------------------------------------
# One timing per signature across a cache hit and a resume
# ---------------------------------------------------------------------------

def test_cache_hit_and_resume_keep_the_first_timings(host, tmp_path):
    """With a noisy timer, ``T_orig`` read from a fresh timing would
    differ from the cached or journaled entries of the same shapes; the
    cached and journaled seconds seed the oracle instead, so both runs
    give the first run's plan and ``T_orig`` bitwise, timing nothing."""
    first = compress(host, budget_ratio=0.8, latency_oracle=_noisy(0),
                     cache_dir=str(tmp_path / "a"))
    ora = _noisy(1)
    hit = compress(host, budget_ratio=0.8, latency_oracle=ora,
                   cache_dir=str(tmp_path / "a"))
    assert hit.tables.stats.cache_hit and ora.num_timed == 0
    assert (hit.plan, hit.original_latency) == (first.plan,
                                                first.original_latency)
    # the same noise stream, killed after the last bucket is journaled
    with faults.inject(faults.Fault("table_cache.publish", "kill")):
        with pytest.raises(faults.FaultKill):
            compress(host, budget_ratio=0.8, latency_oracle=_noisy(0),
                     cache_dir=str(tmp_path / "b"))
    ora = _noisy(2)
    resumed = compress(host, budget_ratio=0.8, latency_oracle=ora,
                       cache_dir=str(tmp_path / "b"))
    assert ora.num_timed == 0
    assert resumed.tables.stats.num_journal_hits == \
        resumed.tables.stats.num_latency_buckets
    assert (resumed.plan, resumed.original_latency) == \
        (first.plan, first.original_latency)
    assert resumed.tables.entries == first.tables.entries


def test_resume_mid_bucket_prices_t_orig_from_the_journal(host, tmp_path):
    """Killed mid-build: every journaled signature's seconds are bitwise
    in the resumed tables and in the ``T_orig`` terms of its layers, and
    the signatures not journaled are timed once."""
    with faults.inject(faults.Fault("tables.bucket", "kill", nth=4)):
        with pytest.raises(faults.FaultKill):
            build_tables(host, latency_oracle=_noisy(0),
                         cache_dir=str(tmp_path))
    key = table_cache.cache_key(host, _noisy(0), "layermerge", "magnitude")
    with open(table_cache.journal_path(str(tmp_path), key)) as f:
        journal = {r["k"]: r["v"] for r in map(json.loads, f)}
    assert len(journal) == 4
    ora = _noisy(1)
    res = compress(host, budget_ratio=0.8, latency_oracle=ora,
                   cache_dir=str(tmp_path))
    assert res.tables.stats.num_journal_hits == 4
    assert ora.num_timed == res.tables.stats.num_latency_buckets - 4
    seen = 0
    for i, j, k, _, _, seg in enumerate_probes(host):
        want = journal.get(f"latb:{host.probe_signature(seg)!r}")
        if want is not None and k in res.tables.entries.get((i, j), {}):
            assert res.tables.entries[(i, j)][k][1] == want
            seen += 1
    assert seen > 0
    layers = [Segment(i=l - 1, j=l, k=host.original_k(l), kept=(l,),
                      original=True) for l in range(1, host.net.L + 1)]
    lats = layer_latencies(host, ora)
    assert sum(lats) == res.original_latency
    for seg, lat in zip(layers, lats):
        sig = host.probe_signature(seg)
        assert lat == ora.measured[sig]        # the value the tables read
        row = res.tables.entries[(seg.i, seg.j)]
        assert seg.k not in row or row[seg.k][1] == lat
        want = journal.get(f"latb:{sig!r}")
        assert want is None or lat == want


# ---------------------------------------------------------------------------
# Probe hardening: retry, timeout, straggler, quarantine, provenance
# ---------------------------------------------------------------------------

def test_flaky_probe_retries_then_succeeds(host):
    with faults.inject(faults.Fault("probe.time", "raise", nth=1, times=2)):
        tb = build_tables(host, latency_oracle=_StubOracle(),
                          probe_config=_fast_probe())
    assert tb.stats.num_probe_retries >= 2
    assert tb.stats.num_quarantined == 0
    assert tb.provenance == {}


def test_flaky_prepare_retries_then_succeeds(host):
    with faults.inject(faults.Fault("probe.prepare", "raise", nth=1,
                                    times=2)):
        tb = build_tables(host, latency_oracle=_StubOracle(),
                          probe_config=_fast_probe())
    assert tb.stats.num_probe_retries == 2
    assert tb.stats.num_quarantined == 0
    assert tb.stats.num_compiles == tb.stats.num_latency_buckets


def test_persistent_failure_quarantines_to_analytic(host):
    cfg = _fast_probe(retries=2)
    with faults.inject(faults.Fault("probe.time", "raise", nth=1, times=3)):
        tb = build_tables(host, latency_oracle=_StubOracle(),
                          probe_config=cfg, prune=False)
    assert tb.stats.num_quarantined == 1       # the first bucket gave up
    assert set(tb.provenance.values()) == {PROBE_QUARANTINED}
    first = enumerate_probes(host)[0][5]
    for (i, j, k) in tb.provenance:
        seg = next(p[5] for p in enumerate_probes(host)
                   if p[:3] == (i, j, k))
        assert host.probe_signature(seg) == host.probe_signature(first)
        assert tb.entries[(i, j)][k][1] == cfg.fallback().segment_latency(
            host.segment_cost(seg))


def test_probe_timeout_quarantines_everything(host):
    tb = build_tables(host, latency_oracle=_StubOracle(),
                      probe_config=_fast_probe(timeout_s=1e-9, retries=0))
    assert tb.stats.num_quarantined == tb.stats.num_latency_buckets
    assert all(lat > 0.0 for row in tb.entries.values()
               for _, lat, _ in row.values())


def test_straggler_delay_recovers_on_retry(host, monkeypatch):
    """A straggler at 4x the budget, against a prepare and a timing that
    do no work: the retry lands microseconds into its budget, whatever
    the load.  (The prepare is timed against the same budget, and a real
    one — the merge and one probe run on the CPU — can overrun 0.25 s on
    a loaded machine and add retries of its own.)"""
    monkeypatch.setattr(probe_engine, "_prepare_probe",
                        lambda host, seg, params: ProbeCallable(
                            lambda: None, ()))
    cfg = _fast_probe(timeout_s=0.25, retries=2)
    with faults.inject(faults.Fault("probe.time", "delay", nth=1,
                                    seconds=1.0)) as plan:
        tb = build_tables(host, latency_oracle=_IdleOracle(),
                          probe_config=cfg)
    assert plan.fired == [("probe.time", 1, "delay")]
    assert tb.stats.num_probe_retries == 1
    assert tb.stats.num_quarantined == 0
    assert tb.provenance == {}


def test_quarantine_disabled_propagates(host):
    cfg = _fast_probe(retries=0, quarantine=False)
    with faults.inject(faults.Fault("probe.time", "raise", times=99)):
        with pytest.raises(faults.FaultError):
            build_tables(host, latency_oracle=_StubOracle(),
                         probe_config=cfg)


def test_kill_is_never_retried(host):
    with faults.inject(faults.Fault("probe.time", "kill")):
        with pytest.raises(faults.FaultKill):
            build_tables(host, latency_oracle=_StubOracle(),
                         probe_config=_fast_probe())


def test_outlier_spread_triggers_retiming_with_provenance(host, tmp_path):
    cfg = _fast_probe(outlier_rel_spread=1.0)
    tb = build_tables(host, latency_oracle=_SpikyOracle(), probe_config=cfg,
                      cache_dir=str(tmp_path), prune=False)
    assert tb.stats.num_retimed == 1
    assert set(tb.provenance.values()) == {PROBE_RETIMED}
    warm = build_tables(host, latency_oracle=_SpikyOracle(),
                        probe_config=cfg, cache_dir=str(tmp_path),
                        prune=False)
    assert warm.stats.cache_hit
    assert warm.provenance == tb.provenance


def test_quarantine_provenance_survives_artifact_roundtrip(host, tmp_path):
    res = compress(host, budget_ratio=1.0, P=100,
                   latency_oracle=_StubOracle(),
                   probe_config=_fast_probe(timeout_s=1e-9, retries=0))
    assert res is not None and len(res.tables.provenance) > 0
    path = str(tmp_path / "flagged.npz")
    res.save(path)
    prov = runtime.load(path, device="cpu").meta["probe_provenance"]
    assert len(prov) == len(res.tables.provenance)
    assert {p["flag"] for p in prov} == {PROBE_QUARANTINED}
    assert PROBE_MEASURED not in {p["flag"] for p in prov}


def test_quarantined_bucket_is_one_value_for_tables_and_t_orig(host):
    """One bucket quarantined: its layers' ``T_orig`` terms are its
    analytic estimate too, not a later successful timing."""
    cfg = _fast_probe(retries=1)
    ora = _StubOracle()
    with faults.inject(faults.Fault("probe.time", "raise", nth=1, times=2)):
        res = compress(host, budget_ratio=1.0, P=100, latency_oracle=ora,
                       probe_config=cfg)
    assert res.tables.stats.num_quarantined == 1
    sig = host.probe_signature(enumerate_probes(host)[0][5])
    assert ora.recall(sig) == (None, PROBE_QUARANTINED)
    layers = [Segment(i=l - 1, j=l, k=host.original_k(l), kept=(l,),
                      original=True) for l in range(1, host.net.L + 1)]
    for seg, lat in zip(layers, layer_latencies(host, ora,
                                                probe_config=cfg)):
        if host.probe_signature(seg) == sig:
            assert lat == cfg.fallback().segment_latency(
                host.segment_cost(seg))


# ---------------------------------------------------------------------------
# Self-healing stores
# ---------------------------------------------------------------------------

def test_corrupt_table_cache_quarantined_and_rebuilt(host, tmp_path):
    build_tables(host, cache_dir=str(tmp_path))
    key = table_cache.cache_key(host, AnalyticOracle(), "layermerge",
                                "magnitude")
    path = tmp_path / f"tables_{key}.json"
    path.write_text(path.read_text()[:40])     # a truncated cache file
    again = build_tables(host, cache_dir=str(tmp_path))
    assert not again.stats.cache_hit           # a miss, not a crash
    assert (tmp_path / f"tables_{key}.json.corrupt").exists()
    assert build_tables(host, cache_dir=str(tmp_path)).stats.cache_hit


def test_corrupt_artifact_quarantined_with_hint(host, tmp_path):
    res = compress(host, budget_ratio=1.0, P=100)
    path = str(tmp_path / "model.npz")
    res.save(path)
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[: len(raw) // 3])
    with pytest.raises(runtime.ArtifactError,
                       match="quarantined to .*corrupt.*re-publish"):
        runtime.load(path, device="cpu")
    assert os.path.exists(path + ".corrupt")
    assert not os.path.exists(path)            # the read path is clear
    res.save(path)                             # recovery: re-publish
    assert runtime.load(path, device="cpu").plan == res.plan


# ---------------------------------------------------------------------------
# A real process crash
# ---------------------------------------------------------------------------

def test_kill_resume_smoke_subprocess():
    """A child dies (exit 17) at its 4th journaled bucket; this process
    resumes it bitwise."""
    out = faults.kill_resume_smoke(kill_at_bucket=4, device="cpu")
    assert out["bit_identical"]
    assert out["journal_hits_on_resume"] >= 3
    assert out["entries_checked_against_journal"] > 0


def test_faults_cli_smoke_flag():
    from repro_torch.testing.subproc import run_module, subprocess_env
    r = run_module("repro_torch.testing.faults", "--smoke", "--device",
                   "cpu", env=subprocess_env(device="cpu"), timeout=300)
    assert "FAULT_SMOKE_OK" in r.stdout, r.stdout + r.stderr


def test_smoke_entry_points_default_to_the_card(monkeypatch):
    """The smoke, its host and the child's environment run on the card
    unless the caller asks for the CPU; a CPU child sees no card."""
    import inspect

    from repro_torch.testing.subproc import subprocess_env
    for fn in (faults.kill_resume_smoke, faults._smoke_host, subprocess_env):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv(faults.ENV_VAR, "raise@probe.time")
    card, cpu = subprocess_env(), subprocess_env(device="cpu",
                                                 faults_spec="exit@x:2")
    assert card["CUDA_VISIBLE_DEVICES"] == "0"
    assert faults.ENV_VAR not in card
    assert cpu["CUDA_VISIBLE_DEVICES"] == ""
    assert cpu[faults.ENV_VAR] == "exit@x:2"
