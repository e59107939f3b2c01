"""The port's distributed table build against the JAX package's, on the CPU.

Counterparts of ``tests/test_dist_build.py``'s cases (the lease protocol,
the shard merge, a manifest's drift, a host spec's fingerprint, the fault
translation, clean 2- and 4-worker fan-outs, a worker killed mid-bucket,
corrupt shard records repaired, a relative work dir, ``workers=0``, an
uncacheable build, a non-main process that writes nothing), and the
parity of the two packages on the same inputs:

* ``latency_work_items`` gives the JAX package's keys for
  ``tiny_resnet_host`` and ``conv_chain_host`` under both engines (the
  port's hosts priced with the JAX package's byte width, ``dtype_bytes=2``:
  the width is part of a bucket's signature);
* a shard, a manifest and lease files written by either package are read
  and merged by the other, with the same first-wins records and the same
  count of garbled lines, and a shard is byte for byte the other's;
* ``worker_env_spec`` gives the JAX package's strings for the same plan;
* a fan-out's tables are bitwise the port's single-process build and,
  with the JAX package's cost model and roofline constants injected, the
  JAX package's latency column bitwise (importances to 1e-6 relative: the
  magnitude proxy sums the same weights in another order), as
  ``tests/test_torch_core.py`` holds the single-process tables.

Workers run on the CPU (``worker_device="cpu"``, hosts with
``device="cpu"``) under the analytic oracle, as the JAX package's tests
run theirs.  The fault cases spawn their workers one after the other
(``serial_spawn=True``), so which worker runs which item, and where a
fault fires, does not depend on the machine's load.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import pytest

from repro.core import dist_build as jdist
from repro.core import latency as jlat
from repro.core.tables import build_tables as j_build_tables
from repro.kernels.merged_conv import _VMEM_BUDGET
from repro.models import cnn_host as jhost
from repro.models import zoo as jzoo
from repro.testing import faults as jfaults
from repro.testing import hosts as jhosts
from repro_torch import runtime
from repro_torch.core import (DistBuildError, build_tables,
                              dist_build_tables, latency_work_items,
                              table_cache)
from repro_torch.core import latency as tlat
from repro_torch.core.dist_build import (LeaseStore, ShardJournal,
                                         merge_shards, read_manifest,
                                         resolve_host_spec, worker_log_path,
                                         write_manifest)
from repro_torch.core.plan import identity_plan
from repro_torch.launch import distributed as dist
from repro_torch.models import cnn as tcnn
from repro_torch.testing import faults, hosts
from repro_torch.testing.subproc import (REPO_ROOT, run_code, run_module,
                                         subprocess_env)

HOST_SPEC = {"factory": "repro_torch.testing.hosts:tiny_resnet_host",
             "kwargs": {"device": "cpu"}}
#: The port's host priced with the JAX package's cost model.
JAX_COST = {"dtype_bytes": 2, "tile_budget": _VMEM_BUDGET}


@pytest.fixture(scope="module")
def smoke_host():
    return hosts.tiny_resnet_host(device="cpu")


@pytest.fixture(scope="module")
def reference(smoke_host):
    host, params = smoke_host
    return build_tables(host, params=params)


def _dist(host, params, cache_dir, workers, spec=HOST_SPEC, **kw):
    return dist_build_tables(host, params=params, cache_dir=str(cache_dir),
                             workers=workers, host_spec=spec,
                             worker_device="cpu", **kw)


def _same(a, b):
    assert a.entries == b.entries
    assert a.num_pruned == b.num_pruned
    assert a.provenance == b.provenance


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factory", ["tiny_resnet_host", "conv_chain_host"])
@pytest.mark.parametrize("engine", ["batched", "sequential"])
def test_work_item_keys_match_the_reference(factory, engine):
    th, _ = getattr(hosts, factory)(device="cpu", dtype_bytes=2)
    jh, _ = getattr(jhosts, factory)()
    t_items = latency_work_items(th, engine=engine)
    j_items = jdist.latency_work_items(jh, engine=engine)
    assert [it.key for it in t_items] == [it.key for it in j_items]
    # the representatives' spans and k (their kept layers follow each
    # package's own random weights)
    assert [(it.seg.i, it.seg.j, it.seg.k) for it in t_items] \
        == [(it.seg.i, it.seg.j, it.seg.k) for it in j_items]
    assert len({it.key for it in t_items}) == len(t_items)


def _write_shards(pkg, wd):
    """Two shards with a duplicate key (w0 wins), a quarantined record,
    a steal event and a garbled line, in either package."""
    w0, w1 = pkg.ShardJournal(wd, "w0"), pkg.ShardJournal(wd, "w1")
    w0.put("latb:('conv', 8)", 1.25e-05, "measured")
    w1.put("latb:('conv', 8)", 2.0, "measured")
    w1.put("lat:0:2:3", None, "quarantined")
    w1.event("steal", item="lat:0:2:3", id=1, prev="w0")
    with open(os.path.join(wd, "shards", "w1.jsonl"), "ab") as f:
        f.write(b"#garbled journal record#\n")
    w1.put("latb:('pool', 3)", 3.0000000000000004e-06, "retimed")


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_shards_manifest_and_leases_cross_the_packages(tmp_path, writer):
    from repro_torch.core import dist_build as tdist

    wpkg, rpkg = (jdist, tdist) if writer == "repro" else (tdist, jdist)
    wd = str(tmp_path / "wd")
    _write_shards(wpkg, wd)
    got = rpkg.merge_shards(wd, ["w0", "w1"])
    assert got == wpkg.merge_shards(wd, ["w0", "w1"])
    records, events, corrupt = got
    assert records["latb:('conv', 8)"] == (1.25e-05, "measured", "w0")
    assert records["lat:0:2:3"] == (None, "quarantined", "w1")
    assert corrupt == 1
    assert events == [{"evt": "steal", "item": "lat:0:2:3", "id": 1,
                       "prev": "w0", "shard": "w1"}]
    # the writer's shard is byte for byte the reader's for the same puts
    other = str(tmp_path / "other")
    _write_shards(rpkg, other)
    for name in ("w0", "w1"):
        with open(tdist.shard_path(wd, name), "rb") as a, \
                open(tdist.shard_path(other, name), "rb") as b:
            assert a.read() == b.read()
    # the manifest: read by the other package, idempotent there, loud on
    # another build
    keys = ["latb:('conv', 8)", "lat:0:2:3"]
    m = wpkg.write_manifest(wd, "k1", [wpkg.WorkItem(k, None) for k in keys],
                            engine="batched", method="layermerge",
                            host_fp="fp")
    assert rpkg.read_manifest(wd) == m
    assert rpkg.write_manifest(wd, "k1", [rpkg.WorkItem(k, None)
                                          for k in keys],
                               engine="batched", method="layermerge",
                               host_fp="fp") == m
    with pytest.raises(rpkg.DistBuildError, match="different build"):
        rpkg.write_manifest(wd, "k2", [], engine="batched",
                            method="layermerge", host_fp="fp")
    # leases: a live lease holds, an expired one is stolen with an epoch
    # bump, done markers are seen
    a = wpkg.LeaseStore(wd, "w0", lease_s=30.0)
    b = rpkg.LeaseStore(wd, "w1", lease_s=30.0)
    assert a.claim(0) == (True, None)
    assert b.claim(0) == (False, None) and b.holder(0) == "w0"
    short = wpkg.LeaseStore(wd, "w0", lease_s=0.05)
    assert short.claim(3) == (True, None)
    time.sleep(0.1)
    assert b.claim(3) == (True, "w0")
    with open(os.path.join(wd, "leases", "3.json")) as f:
        assert json.load(f)["epoch"] == 2
    a.mark_done(2)
    assert b.is_done(2) and b.count_done(4) == 1


def test_worker_env_spec_matches_the_reference():
    rules = [("dist.item", "kill-worker", dict(nth=40, widx=0)),
             ("dist.claim", "stall-worker", dict(seconds=0.5, widx=1)),
             ("", "corrupt-shard", dict(nth=1, times=2, widx=1)),
             ("probe.time", "raise", dict(nth=2))]
    with faults.inject(*(faults.Fault(p, a, **kw) for p, a, kw in rules)):
        port = [faults.worker_env_spec(w) for w in range(3)]
    with jfaults.inject(*(jfaults.Fault(p, a, **kw) for p, a, kw in rules)):
        ref = [jfaults.worker_env_spec(w) for w in range(3)]
    assert port == ref
    spec = "kill-worker:0@dist.item:40;stall-worker:1@dist.claim:2~0.5"
    assert faults.parse_env_spec(spec).rules == tuple(
        faults.Fault(**dataclasses.asdict(r))
        for r in jfaults.parse_env_spec(spec).rules)


def test_fanout_equals_the_reference_under_its_constants(tmp_path):
    """The JAX package's cost model and constants injected: the fan-out's
    latency column is bitwise ``repro``'s single-process build on the
    same parameters, its keys and kept sets equal, importances to 1e-6."""
    th, tparams = hosts.tiny_resnet_host(device="cpu", **JAX_COST)
    ora = tlat.AnalyticOracle(peak_flops=jlat.PEAK_FLOPS_BF16,
                              hbm_bw=jlat.HBM_BW, op_overhead=1e-6)
    spec = {"factory": HOST_SPEC["factory"],
            "kwargs": {"device": "cpu", **JAX_COST}}
    tt, rep = _dist(th, tparams, tmp_path, 2, spec=spec, latency_oracle=ora,
                    lease_s=10.0)
    assert rep.dead_workers == [] and rep.exit_codes == {0: 0, 1: 0}
    assert sum(rep.completed_by.values()) == rep.items
    jparams = jax.tree.map(jnp.asarray, tcnn.params_to_numpy(tparams))
    jh = jhost.CNNHost(jzoo.tiny_resnet(num_classes=4, in_hw=8, width=4,
                                        blocks=(2,)), jparams, batch=th.batch)
    jt = j_build_tables(jh, latency_oracle=jlat.AnalyticTPUOracle())
    assert tt.entries.keys() == jt.entries.keys()
    for span, row in jt.entries.items():
        assert tt.entries[span].keys() == row.keys(), span
        for k, (imp, lat, kept) in row.items():
            timp, tlat_, tkept = tt.entries[span][k]
            assert tlat_ == lat, (span, k)
            assert tkept == kept
            assert timp == pytest.approx(imp, rel=1e-6)
    assert tt.num_pruned == jt.num_pruned


# ---------------------------------------------------------------------------
# Counterparts of the reference's cases: the lease protocol
# ---------------------------------------------------------------------------

def test_lease_claim_renew_release(tmp_path):
    a = LeaseStore(str(tmp_path), "w0", lease_s=30.0)
    b = LeaseStore(str(tmp_path), "w1", lease_s=30.0)
    got, stolen = a.claim(0)
    assert got and stolen is None
    assert b.claim(0) == (False, None)      # a live foreign lease holds
    assert a.claim(0) == (True, None)       # our own: renewed
    assert a.renew(0)
    assert b.holder(0) == "w0"
    b.release(0)                            # release is the owner's only
    assert a.holder(0) == "w0"
    a.release(0)
    assert a.holder(0) is None
    assert b.claim(0) == (True, None)


def test_lease_expiry_steal_and_epoch(tmp_path):
    a = LeaseStore(str(tmp_path), "w0", lease_s=0.05)
    b = LeaseStore(str(tmp_path), "w1", lease_s=30.0)
    assert a.claim(3) == (True, None)
    time.sleep(0.1)                          # w0's lease expires
    got, stolen = b.claim(3)
    assert got and stolen == "w0"
    with open(os.path.join(str(tmp_path), "leases", "3.json")) as f:
        rec = json.load(f)
    assert rec["owner"] == "w1" and rec["epoch"] == 2
    assert not a.renew(3)                    # the loser sees the steal


def test_done_markers(tmp_path):
    s = LeaseStore(str(tmp_path), "w0", lease_s=30.0)
    assert not s.is_done(1)
    s.mark_done(1)
    assert s.is_done(1)
    assert s.count_done(3) == 1


# ---------------------------------------------------------------------------
# Shards, the merge, specs
# ---------------------------------------------------------------------------

def test_merge_shards_first_wins_and_corrupt(tmp_path):
    wd = str(tmp_path)
    w0, w1 = ShardJournal(wd, "w0"), ShardJournal(wd, "w1")
    w0.put("a", 1.0, "measured")
    w1.put("a", 2.0, "measured")             # a duplicate: w0 wins
    w1.put("b", 3.0, "quarantined")
    w1.event("steal", item="b", id=1, prev="w0")
    with open(os.path.join(wd, "shards", "w1.jsonl"), "ab") as f:
        f.write(faults.GARBLED_LINE)
    records, events, corrupt = merge_shards(wd, ["w0", "w1"])
    assert records["a"] == (1.0, "measured", "w0")
    assert records["b"] == (3.0, "quarantined", "w1")
    assert corrupt == 1
    assert events == [{"evt": "steal", "item": "b", "id": 1, "prev": "w0",
                       "shard": "w1"}]
    rev, _, _ = merge_shards(wd, ["w1", "w0"])   # the order decides
    assert rev["a"] == (2.0, "measured", "w1")


def test_manifest_idempotent_and_drift_loud(tmp_path, smoke_host):
    host, _params = smoke_host
    items = latency_work_items(host)
    wd = str(tmp_path)
    m1 = write_manifest(wd, "k1", items, engine="batched",
                        method="layermerge", host_fp="fp")
    m2 = write_manifest(wd, "k1", items, engine="batched",
                        method="layermerge", host_fp="fp")
    assert m1 == m2 == read_manifest(wd)
    with pytest.raises(DistBuildError, match="different build"):
        write_manifest(wd, "k2", items, engine="batched",
                       method="layermerge", host_fp="fp")


def test_host_spec_roundtrip_same_fingerprint(smoke_host):
    host, _params = smoke_host
    rebuilt, _p = resolve_host_spec(HOST_SPEC)
    assert rebuilt.fingerprint() == host.fingerprint()
    other, _p = resolve_host_spec({"factory": HOST_SPEC["factory"],
                                   "kwargs": {"device": "cpu", "seed": 1}})
    assert other.fingerprint() != host.fingerprint()
    with pytest.raises(DistBuildError, match="module:function"):
        resolve_host_spec({"factory": "nonsense"})
    with pytest.raises(DistBuildError, match="cannot resolve"):
        resolve_host_spec({"factory": "repro_torch.testing.hosts:nope"})


def test_worker_env_spec_translation():
    with faults.inject(
            faults.Fault("dist.item", "kill-worker", nth=2, widx=0),
            faults.Fault("dist.claim", "stall-worker", seconds=0.5,
                         widx=1),
            faults.Fault("", "corrupt-shard", widx=1)) as plan:
        assert faults.worker_env_spec(0) == "exit@dist.item:2x1"
        assert faults.worker_env_spec(1) == \
            "delay@dist.claim:1x1~0.5;garble@dist.shard.append:1x1"
        assert faults.worker_env_spec(2) is None
        # worker-targeted rules never fire in the process holding the plan
        faults.hit("dist.item")
        faults.hit("dist.item")
        assert plan.fired == []
    assert faults.worker_env_spec(0) is None  # no active plan
    rule, = faults.parse_env_spec("kill-worker:0@dist.item:40").rules
    assert (rule.action, rule.widx, rule.point, rule.nth) == \
        ("kill-worker", 0, "dist.item", 40)


# ---------------------------------------------------------------------------
# Fan-outs: bitwise the single-process build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [2, 4])
def test_clean_fanout_bit_identical(smoke_host, reference, tmp_path,
                                    workers):
    host, params = smoke_host
    tables, rep = _dist(host, params, tmp_path, workers, lease_s=10.0)
    _same(tables, reference)
    assert rep.dead_workers == [] and not rep.cache_hit
    assert rep.exit_codes == {w: 0 for w in range(workers)}
    assert sum(rep.completed_by.values()) == rep.items
    assert sum(line["items_done"] for line in rep.worker_lines.values()) \
        >= rep.items
    assert not [p for p in os.listdir(tmp_path) if p.startswith("dist_")]
    _t2, rep2 = _dist(host, params, tmp_path, workers)
    assert rep2.cache_hit and not rep2.exit_codes   # no worker spawned


def test_killed_worker_lease_reassigned(smoke_host, reference, tmp_path):
    """Worker 0 dies at its 2nd item holding the lease (exit 17, no
    result); worker 1, started after it, steals the expired lease; the
    merged tables are bitwise the single-process build, and the work dir
    is kept with the dead worker's log."""
    host, params = smoke_host
    items = latency_work_items(host)
    with faults.inject(faults.Fault("dist.item", "kill-worker", nth=2,
                                    widx=0)):
        tables, rep = _dist(host, params, tmp_path, 2, lease_s=0.5,
                            serial_spawn=True)
    assert rep.dead_workers == [0] and rep.exit_codes == {0: 17, 1: 0}
    assert rep.reassigned == [items[1].key]
    assert rep.completed_by == {"w0": 1, "w1": len(items) - 1}
    assert rep.worker_lines[0] is None
    assert rep.worker_lines[1]["items_done"] == len(items) - 1
    _same(tables, reference)
    wd, = [p for p in tmp_path.iterdir() if p.name.startswith("dist_")]
    assert os.path.exists(worker_log_path(str(wd), 0))


def test_every_worker_dead_the_coordinator_builds(smoke_host, reference,
                                                  tmp_path):
    host, params = smoke_host
    with faults.inject(faults.Fault("dist.claim", "kill-worker", widx=0),
                       faults.Fault("dist.claim", "kill-worker", widx=1)):
        tables, rep = _dist(host, params, tmp_path, 2, lease_s=0.2)
    assert rep.dead_workers == [0, 1]
    assert rep.coordinator_items == rep.items
    _same(tables, reference)


def test_corrupt_shard_records_repaired(smoke_host, reference, tmp_path):
    """Worker 0 runs alone first (``serial_spawn``) and garbles its first
    two shard records: both are counted and run again in the coordinator,
    whatever the load; the tables stay bitwise."""
    host, params = smoke_host
    items = latency_work_items(host)
    with faults.inject(faults.Fault("", "corrupt-shard", nth=1, times=2,
                                    widx=0)):
        tables, rep = _dist(host, params, tmp_path, 2, lease_s=10.0,
                            serial_spawn=True)
    assert rep.corrupt_records == 2
    assert rep.repaired == [items[0].key, items[1].key]
    assert rep.exit_codes == {0: 0}           # worker 1 was not needed
    _same(tables, reference)


def test_relative_work_dir_from_foreign_cwd(smoke_host, reference,
                                            tmp_path, monkeypatch):
    """Workers run in the repo root: relative cache and work dirs still
    reach them, and each worker leaves a log."""
    host, params = smoke_host
    monkeypatch.chdir(tmp_path)
    tables, rep = _dist(host, params, "cache", 2, work_dir="wd",
                        keep_work_dir=True, lease_s=10.0)
    _same(tables, reference)
    assert rep.dead_workers == []
    assert sum(rep.completed_by.values()) == rep.items
    assert rep.coordinator_items == 0
    for w in range(2):
        assert os.path.exists(worker_log_path(str(tmp_path / "wd"), w))


def test_sequential_engine_fanout_replays_lat_keys(smoke_host, tmp_path):
    """Sequential work items carry ``lat:i:j:k`` keys (the JAX package's);
    the coordinator's resume replays them bucket by bucket."""
    host, params = smoke_host
    single = build_tables(host, params=params, engine="sequential")
    tables, rep = _dist(host, params, tmp_path, 2, engine="sequential",
                        lease_s=10.0)
    assert rep.items == len(latency_work_items(host, engine="sequential"))
    assert tables.stats.num_journal_hits == tables.stats.num_latency_buckets
    _same(tables, single)


def test_workers_zero_degenerates_to_local(smoke_host, reference,
                                           tmp_path):
    host, params = smoke_host
    tables, rep = dist_build_tables(host, params=params,
                                    cache_dir=str(tmp_path), workers=0)
    _same(tables, reference)
    assert rep.coordinator_items == 0 and rep.completed_by == {}
    assert not rep.exit_codes


def test_uncacheable_build_is_loud(tmp_path):
    class NoFingerprint:
        pass

    with pytest.raises(DistBuildError, match="content-addressable"):
        dist_build_tables(NoFingerprint(), cache_dir=str(tmp_path),
                          workers=2)


def test_drifted_worker_exits_3(smoke_host, tmp_path):
    """A worker whose rebuilt host has another fingerprint than the
    manifest's refuses to run: exit 3, nothing merged."""
    host, _params = smoke_host
    wd = str(tmp_path)
    write_manifest(wd, "k", latency_work_items(host), engine="batched",
                   method="layermerge", host_fp=host.fingerprint())
    drift = {"factory": HOST_SPEC["factory"],
             "kwargs": {"device": "cpu", "seed": 1}}
    r = run_module("repro_torch.launch.distributed", "--worker", "--dir", wd,
                   "--host-spec", json.dumps(drift), check=False,
                   env=dist.worker_env(0, 1, device="cpu"), timeout=120)
    assert r.returncode == 3, r.stdout + r.stderr
    assert "fingerprint differs" in r.stdout
    assert not os.path.exists(os.path.join(wd, "shards"))


# ---------------------------------------------------------------------------
# Publish gating, process identity, the entry points
# ---------------------------------------------------------------------------

def test_non_main_process_writes_nothing(smoke_host, reference, tmp_path,
                                         monkeypatch):
    """With a non-zero process index every publish — table cache, build
    journal, artifact, gated text and JSON — leaves the disk untouched
    while still returning its in-memory result."""
    host, params = smoke_host
    graph = host.lower_plan(identity_plan(host.net.L, host.descs()))
    main_fp = runtime.save(str(tmp_path / "main.npz"), graph)

    monkeypatch.setenv(dist.ENV_PROCESS_ID, "1")
    monkeypatch.setenv(dist.ENV_NUM_PROCESSES, "2")
    assert dist.process_index() == 1 and dist.process_count() == 2
    assert not dist.is_main() and not table_cache.is_main()

    d = tmp_path / "nonmain"
    path = table_cache.save(str(d), "k" * 8, reference)
    assert not os.path.exists(path)
    j = table_cache.BuildJournal(str(d), "k" * 8)
    j.put("lat:0:1:1", 1.0)
    assert j.put_many([("a", 1.0, "measured")]) == 1
    assert j.get("a") == (1.0, "measured")
    assert not os.path.exists(j.path)
    fp = runtime.save(str(d / "m.npz"), graph)
    assert fp == main_fp and not os.path.exists(str(d / "m.npz"))
    assert dist.publish_text(str(d / "t.txt"), "x") is None
    assert dist.publish_json(str(d / "b.json"), {"x": 1}) is None
    assert not os.path.exists(str(d))

    monkeypatch.setenv(dist.ENV_PROCESS_ID, "0")
    assert dist.is_main()
    assert dist.publish_json(str(d / "b.json"), {"x": 1}) is not None
    with open(d / "b.json") as f:
        assert json.load(f) == {"x": 1}


def test_worker_env_and_run_code_carry_the_identity():
    env = dist.worker_env(2, 3, device="cpu",
                          faults_spec="exit@dist.item:1x1")
    assert env[dist.ENV_PROCESS_ID] == "3"
    assert env[dist.ENV_NUM_PROCESSES] == "4"
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert env[faults.ENV_VAR] == "exit@dist.item:1x1"
    assert env["PYTHONPATH"].split(os.pathsep)[0].endswith("src")
    assert dist.ENV_PROCESS_ID not in subprocess_env(device="cpu")
    r = run_code("""
        from repro_torch.launch import distributed as d
        print(d.init_runtime(), d.process_count(), d.is_main())
        """, env=env, timeout=120)
    assert r.stdout.split() == ["3", "4", "False"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_runtime_joins_a_gloo_group():
    """With a coordinator address, two processes form a ``gloo`` group on
    the CPU; identity is the group's rank."""
    addr = f"tcp://127.0.0.1:{_free_port()}"
    code = ("import sys, torch, torch.distributed as td\n"
            "from repro_torch.launch import distributed as d\n"
            f"r = d.init_runtime({addr!r}, 2, int(sys.argv[1]), "
            "device='cpu')\n"
            "t = torch.tensor([r + 1.0]); td.all_reduce(t)\n"
            "print(r, d.process_index(), d.process_count(), d.is_main(), "
            "float(t))\n"
            "td.destroy_process_group()\n")
    env = subprocess_env(device="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env,
                              cwd=REPO_ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o.split() for o, _ in outs] == [["0", "0", "2", "True", "3.0"],
                                            ["1", "1", "2", "False", "3.0"]]


def test_survivor_mesh_names_the_roadmap_item():
    """survivor_mesh is ported (ROADMAP.md queue 1 item 5a): in one
    process with no process group it re-forms the one-rank mesh, and it
    raises when every rank is excluded (the four-rank case is in
    ``tests/test_torch_mesh.py``)."""
    mesh = dist.survivor_mesh(exclude=(1,))
    assert mesh.shape == {"data": 1} and mesh.coords == {"data": 0}
    with pytest.raises(RuntimeError, match="no surviving devices"):
        dist.survivor_mesh(exclude=(0,))


@pytest.mark.parametrize("flag,ok", [("--smoke", "DIST_SMOKE_OK"),
                                     ("--fault-smoke", "DIST_FAULT_SMOKE_OK")])
def test_distributed_smokes_on_the_cpu(flag, ok):
    r = run_module("repro_torch.launch.distributed", flag, "--device", "cpu",
                   env=subprocess_env(device="cpu"), timeout=300)
    assert r.stdout.strip().splitlines()[-1] == ok


def test_cli_workers_prints_the_dist_block(tmp_path):
    """``--workers 2`` through the CLI: the ``"dist"`` block carries the
    JAX package's keys; a second run is a cache hit; ``--workers``
    without ``--cache-dir`` exits 3."""
    args = ["--arch", "tiny_resnet", "--device", "cpu", "--workers", "2",
            "--cache-dir", str(tmp_path / "c"), "--out",
            str(tmp_path / "t.npz")]
    env = subprocess_env(device="cpu")
    runs = [json.loads(run_module("repro_torch.compress", *args, env=env,
                                  timeout=300).stdout) for _ in range(2)]
    for run in runs:
        assert {"workers", "items", "reassigned", "dead_workers",
                "cache_hit"} <= set(run["dist"])
    first, second = (r["dist"] for r in runs)
    assert first["workers"] == 2 and first["dead_workers"] == []
    assert not first["cache_hit"] and first["items"] > 0
    assert sum(first["completed_by"].values()) == first["items"]
    assert second["cache_hit"] and runs[1]["cache_hit"]
    assert runs[0]["fingerprint"] == runs[1]["fingerprint"]
    r = run_module("repro_torch.compress", "--arch", "tiny_resnet",
                   "--device", "cpu", "--workers", "2", "--out",
                   str(tmp_path / "u.npz"), env=env, check=False,
                   timeout=300)
    assert r.returncode == 3 and "requires cache_dir" in r.stdout
