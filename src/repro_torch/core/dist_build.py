"""The distributed table build: lease-based fan-out of the latency probes
over worker processes.

Table construction is the paper's wall-clock bottleneck and is
embarrassingly parallel (§3.2): every latency bucket is independent.
This module shards one build's bucket list over worker processes and
merges their results into tables **bitwise** those of a single-process
build under the analytic oracle, whichever workers died when.  The port's
copy of the JAX package's ``repro.core.dist_build``; its files are that
module's byte for byte, so a manifest, a lease or a shard written by
either package is read and merged by the other.

Files, not RPC
--------------
Coordination goes through a shared ``work_dir`` (POSIX atomic rename and
``O_EXCL`` create), so one code path serves subprocesses on one machine
and a fleet on a shared filesystem:

* ``manifest.json`` — the ordered work-item list (one key per latency
  bucket), written once, atomically, by the coordinator; an item's id is
  its index there, and names its lease and done files.
* ``leases/<id>.json`` — ``{"owner", "expires", "epoch"}``; a claim is an
  ``O_CREAT|O_EXCL`` create; the lease expires ``lease_s`` out and is
  renewed only between probe attempts (the lease IS the heartbeat).
  Stealing an expired lease is a tmp write, ``os.replace`` and a
  read-back; the loser of a steal race reads the winner and walks away.
* ``shards/<worker>.jsonl`` — each worker's fsync'd results in the build
  journal's record format (``{"k","v","p"}``), and ``{"evt": "steal"}``
  audit records.
* ``done/<id>`` — completion markers (the result is durably in a shard).

Execution is at-least-once (a straggler may finish an item that was
stolen and run again); attribution is exactly-once: the merge reads the
shards in a fixed order (w0, w1, …, coordinator) and keeps the first
record of each key, so the merged set is a function of the shards.  The
merged records go into the coordinator's
:class:`~repro_torch.core.table_cache.BuildJournal` in one fsync, and the
build finishes through ``build_tables(resume=True)``: its journal replay
makes the tables the records' (a wall-clock record seeds the oracle, so
``T_orig`` priced afterwards reads the workers' seconds too).

Liveness: after every worker has exited (or the deadline passed), the
coordinator runs any unfinished item inline — leases ignored, their
holders are dead — and runs again items whose done marker exists but
whose shard record is lost or corrupt (``repaired``).  A build completes
even when every worker dies at once.

Fault points (:mod:`repro_torch.testing.faults`): ``dist.claim``,
``dist.item`` (after the claim, before the probe: a kill here dies
holding the lease with no result), ``dist.done``, and
``dist.shard.append`` / ``dist.shard.append.done`` in every shard write
(``corrupt-shard`` garbles there).  Worker-targeted rules
(``kill-worker:<idx>@point``) reach each worker's ``REPRO_FAULTS``
through :func:`~repro_torch.testing.faults.worker_env_spec`.

Two differences from the JAX package: workers run on the card by
default (``worker_device="cuda"``; the JAX package defaults its workers
to the CPU platform), and a work directory in which a worker died is kept
after the build, for the worker's log (``logs/w<idx>.log``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

from repro_torch.testing import faults

from . import probe_engine, table_cache
from .latency import AnalyticOracle, WallClockOracle
from .tables import _hand_back_timings, build_tables, enumerate_probes

#: The module a worker runs as ``python -m`` (the launch layer owns the
#: command line; named here as data only).
WORKER_MODULE = "repro_torch.launch.distributed"


class DistBuildError(RuntimeError):
    """A distributed build cannot go on (bad specs, drift, a deadline)."""


@dataclasses.dataclass(frozen=True)
class WorkItem:
    """One distributable unit: a journal key and its representative
    segment (the first of its bucket in enumeration order)."""

    key: str
    seg: object


def latency_work_items(host, method: str = "layermerge",
                       engine: str = "batched") -> list[WorkItem]:
    """The build's latency work items, in a deterministic order.

    The enumeration is ``build_tables``' own
    (:func:`~repro_torch.core.tables.enumerate_probes`) and the keys are
    the build journal's — ``latb:<signature>`` per shape bucket (batched)
    or ``lat:<i>:<j>:<k>`` per entry (sequential), the JAX package's
    keys — so a merged shard record is the record the coordinator would
    have journaled itself.
    """
    items: list[WorkItem] = []
    seen: set = set()
    for p in enumerate_probes(host, method):
        seg = p[5]
        if engine == "sequential":
            key = f"lat:{seg.i}:{seg.j}:{seg.k}"
        else:
            key = f"latb:{probe_engine._signature(host, seg)!r}"
        if key not in seen:
            seen.add(key)
            items.append(WorkItem(key, seg))
    return items


# ---------------------------------------------------------------------------
# Specs that cross processes (a host holds live tensors: each worker
# rebuilds it from a JSON description)
# ---------------------------------------------------------------------------

def resolve_host_spec(spec: dict):
    """``{"factory": "module:function", "kwargs": {...}}`` → (host, params).

    Factories must be seed-deterministic (see
    :mod:`repro_torch.testing.hosts`); the worker checks the rebuilt
    host's fingerprint against the coordinator's manifest, so drift fails
    loudly instead of merging another host's timings.
    """
    factory = str(spec.get("factory", ""))
    mod_name, sep, fn_name = factory.partition(":")
    if not sep or not fn_name:
        raise DistBuildError(
            f'host spec factory must be "module:function", got {factory!r}')
    import importlib

    try:
        fn = getattr(importlib.import_module(mod_name), fn_name)
    except (ImportError, AttributeError) as e:
        raise DistBuildError(f"cannot resolve host factory {factory!r}: {e}")
    return fn(**spec.get("kwargs", {}))


def oracle_spec(oracle) -> dict:
    cfg = dataclasses.asdict(oracle) if dataclasses.is_dataclass(oracle) \
        else {}
    return {"cls": type(oracle).__name__, "cfg": cfg}


def resolve_oracle_spec(spec: dict | None):
    """An oracle of :mod:`repro_torch.core.latency` (``AnalyticOracle``,
    ``WallClockOracle``) from :func:`oracle_spec`'s description."""
    from . import latency

    spec = spec or {"cls": "AnalyticOracle"}
    cls = getattr(latency, str(spec.get("cls", "")), None)
    if not (isinstance(cls, type) and issubclass(cls, latency.LatencyOracle)):
        raise DistBuildError(f"unknown oracle class {spec.get('cls')!r}")
    return cls(**spec.get("cfg", {}))


def probe_spec(cfg) -> dict | None:
    """ProbeConfig → a JSON-able dict.  ``fallback_oracle`` does not ship:
    workers journal None for a quarantined bucket, and the coordinator's
    replay derives the fallback estimate."""
    if cfg is None:
        return None
    d = dataclasses.asdict(cfg)
    d.pop("fallback_oracle", None)
    return d


def resolve_probe_spec(spec: dict | None):
    if not spec:
        return None
    return probe_engine.ProbeConfig(**spec)


# ---------------------------------------------------------------------------
# Work-directory primitives: manifest, leases, shards
# ---------------------------------------------------------------------------

def _manifest_path(work_dir: str) -> str:
    return os.path.join(work_dir, "manifest.json")


def read_manifest(work_dir: str) -> dict | None:
    try:
        with open(_manifest_path(work_dir)) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, json.JSONDecodeError, ValueError) as e:
        raise DistBuildError(f"corrupt manifest in {work_dir!r}: {e}")


def write_manifest(work_dir: str, cache_key: str, items, *,
                   engine: str, method: str,
                   host_fp: str | None = None) -> dict:
    """Publish the ordered work list once, atomically; idempotent for the
    same build, loud for another (a stale work dir must not mix two
    builds' shards)."""
    payload = {"cache_key": cache_key, "engine": engine, "method": method,
               "host_fp": host_fp, "items": [it.key for it in items]}
    existing = read_manifest(work_dir)
    if existing is not None:
        if existing != payload:
            raise DistBuildError(
                f"work dir {work_dir!r} already holds a manifest for a "
                "different build — use a fresh work dir")
        return existing
    from repro_torch.checkpoint.ckpt import atomic_write_text

    atomic_write_text(_manifest_path(work_dir), json.dumps(payload))
    return payload


def _await_manifest(work_dir: str, wait_s: float = 15.0,
                    poll_s: float = 0.1) -> dict:
    deadline = time.monotonic() + wait_s
    while True:
        m = read_manifest(work_dir)
        if m is not None:
            return m
        if time.monotonic() > deadline:
            raise DistBuildError(f"no manifest appeared in {work_dir!r}")
        time.sleep(poll_s)


class LeaseStore:
    """File leases on work items, reassigned when they expire.

    A lease is ``{"owner", "expires", "epoch"}``.  Claiming a free item
    is atomic (``O_CREAT|O_EXCL``); stealing an expired lease bumps the
    epoch through a tmp write and ``os.replace``, then reads the file
    back — another owner or epoch there means another stealer won and
    this one walks away.  Leases only order the work: correctness never
    rests on mutual exclusion (a duplicate run merges deterministically),
    so the read-then-replace window is harmless.
    """

    def __init__(self, work_dir: str, owner: str, lease_s: float):
        self.lease_dir = os.path.join(work_dir, "leases")
        self.done_dir = os.path.join(work_dir, "done")
        os.makedirs(self.lease_dir, exist_ok=True)
        os.makedirs(self.done_dir, exist_ok=True)
        self.owner = owner
        self.lease_s = float(lease_s)

    def _lease(self, item_id: int) -> str:
        return os.path.join(self.lease_dir, f"{item_id}.json")

    @staticmethod
    def _read(path: str) -> dict | None:
        try:
            with open(path) as f:
                rec = json.load(f)
            return rec if isinstance(rec, dict) else None
        except (OSError, json.JSONDecodeError, ValueError):
            return None

    def holder(self, item_id: int) -> str | None:
        rec = self._read(self._lease(item_id))
        return rec.get("owner") if rec else None

    def claim(self, item_id: int) -> tuple[bool, str | None]:
        """Try to lease ``item_id``: ``(claimed, stolen_from)``, where
        ``stolen_from`` names the previous holder of an expired (or
        unreadable) lease this claim took over — the caller records it
        as a ``steal`` event."""
        path = self._lease(item_id)
        rec = {"owner": self.owner,
               "expires": time.time() + self.lease_s, "epoch": 1}
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            cur = self._read(path)
            if cur is not None and cur.get("owner") == self.owner:
                self.renew(item_id)          # our own lease: extend it
                faults.hit("dist.claim")
                return True, None
            if cur is not None and \
                    float(cur.get("expires", 0.0)) > time.time():
                return False, None           # a live lease elsewhere
            rec["epoch"] = (int(cur.get("epoch", 0)) + 1) if cur else 1
            tmp = f"{path}.{self.owner}.tmp"
            try:
                with open(tmp, "w") as f:
                    json.dump(rec, f)
                os.replace(tmp, path)
            except OSError:
                return False, None
            back = self._read(path)
            if not back or back.get("owner") != self.owner \
                    or back.get("epoch") != rec["epoch"]:
                return False, None           # lost the steal race
            faults.hit("dist.claim")
            return True, (cur.get("owner", "?") if cur else "?")
        with os.fdopen(fd, "w") as f:
            json.dump(rec, f)
        faults.hit("dist.claim")
        return True, None

    def renew(self, item_id: int) -> bool:
        """Extend our own lease (between probe attempts: the heartbeat);
        False when it was stolen from us meanwhile."""
        path = self._lease(item_id)
        cur = self._read(path)
        if cur is None or cur.get("owner") != self.owner:
            return False
        cur["expires"] = time.time() + self.lease_s
        tmp = f"{path}.{self.owner}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(cur, f)
            os.replace(tmp, path)
        except OSError:
            return False
        return True

    def release(self, item_id: int) -> None:
        cur = self._read(self._lease(item_id))
        if cur is not None and cur.get("owner") != self.owner:
            return                           # not ours to release
        try:
            os.remove(self._lease(item_id))
        except OSError:
            pass

    def mark_done(self, item_id: int) -> None:
        try:
            with open(os.path.join(self.done_dir, str(item_id)), "w") as f:
                f.write(self.owner)
        except OSError:
            pass

    def is_done(self, item_id: int) -> bool:
        return os.path.exists(os.path.join(self.done_dir, str(item_id)))

    def count_done(self, n: int) -> int:
        return sum(1 for i in range(n) if self.is_done(i))


def shard_path(work_dir: str, name: str) -> str:
    return os.path.join(work_dir, "shards", f"{name}.jsonl")


class ShardJournal:
    """One worker's fsync'd result shard (append-only JSONL).

    Result records are the build journal's ``{"k","v","p"}``, so the
    merge drops them straight into the coordinator's journal; ``{"evt":
    ...}`` records in the same file are the steal audit trail.  Appends go
    through :func:`repro_torch.checkpoint.ckpt.append_journal_line` at
    fault point ``dist.shard.append`` (where ``corrupt-shard`` garbles).
    Shards are written by workers, so they are not gated on ``is_main``.
    """

    def __init__(self, work_dir: str, name: str):
        self.name = name
        self.path = shard_path(work_dir, name)

    def put(self, key: str, value, provenance: str = "measured") -> None:
        from repro_torch.checkpoint.ckpt import append_journal_line

        append_journal_line(self.path, json.dumps(
            {"k": key, "v": value, "p": provenance}),
            point="dist.shard.append")

    def event(self, kind: str, **fields) -> None:
        from repro_torch.checkpoint.ckpt import append_journal_line

        append_journal_line(self.path, json.dumps({"evt": kind, **fields}),
                            point="dist.shard.append")


def merge_shards(work_dir: str, names) -> tuple[dict, list, int]:
    """First-wins merge of the shards in the given order:
    ``(records, events, corrupt)``.

    ``records`` maps a journal key to ``(value, provenance, shard name)``
    of its first record in shard order, then file order, so the merge is
    a function of the shard set (duplicate runs after a steal collapse
    the same way on every merge).  Unparsable lines (torn by a kill,
    garbled by ``corrupt-shard``) are counted, never trusted: the
    coordinator runs whatever they were again.
    """
    from repro_torch.checkpoint.ckpt import read_journal_lines

    records: dict[str, tuple] = {}
    events: list[dict] = []
    corrupt = 0
    for name in names:
        for line in read_journal_lines(shard_path(work_dir, name)):
            try:
                rec = json.loads(line)
            except (json.JSONDecodeError, ValueError):
                corrupt += 1
                continue
            if not isinstance(rec, dict):
                corrupt += 1
                continue
            if "evt" in rec:
                events.append(dict(rec, shard=name))
                continue
            if "k" not in rec or "v" not in rec:
                corrupt += 1
                continue
            records.setdefault(
                rec["k"], (rec["v"], rec.get("p", "measured"), name))
    return records, events, corrupt


# ---------------------------------------------------------------------------
# The worker loop
# ---------------------------------------------------------------------------

def run_worker(work_dir: str, worker_id: int, host, params, oracle, *,
               engine: str = "batched", method: str = "layermerge",
               probe_config=None, lease_s: float = 30.0,
               poll_s: float = 0.2, deadline_s: float = 600.0,
               stats: probe_engine.EngineStats | None = None) -> int:
    """Claim, probe and journal until every manifest item is done; the
    number of items this worker completed.

    The worker derives the work list from its own rebuilt host and checks
    it against the manifest: an unknown key or another fingerprint is
    host-spec drift (:class:`DistBuildError`, exit 3 at the command
    line).  Each worker starts at its own rotation of the manifest, so
    concurrent workers mostly claim different items; an expired lease
    met on a later sweep is stolen and the steal journaled.  ``stats``
    (optional) collects the probes' retries, re-timings and quarantines.
    """
    manifest = _await_manifest(work_dir)
    items = latency_work_items(host, method=method, engine=engine)
    by_key = {it.key: it for it in items}
    unknown = [k for k in manifest["items"] if k not in by_key]
    if unknown:
        raise DistBuildError(
            f"worker host does not produce {len(unknown)} manifest "
            f"item(s) (first: {unknown[0]!r}) — host spec drift?")
    fp_fn = getattr(host, "fingerprint", None)
    if fp_fn is not None and manifest.get("host_fp") \
            and fp_fn() != manifest["host_fp"]:
        raise DistBuildError(
            "worker host fingerprint differs from the coordinator's — "
            "host spec drift?")

    n = len(manifest["items"])
    nw = max(1, int(os.environ.get("REPRO_NUM_PROCESSES", "2")) - 1)
    start = (worker_id * n) // nw if n else 0
    order = list(range(start, n)) + list(range(start))

    cfg = probe_config or probe_engine.ProbeConfig()
    stats = stats if stats is not None else \
        probe_engine.EngineStats(engine=engine)
    shard = ShardJournal(work_dir, f"w{worker_id}")
    store = LeaseStore(work_dir, f"w{worker_id}", lease_s)
    completed = 0
    deadline = time.monotonic() + deadline_s
    while True:
        progressed = False
        remaining = [i for i in order if not store.is_done(i)]
        if not remaining:
            return completed
        for i in remaining:
            if store.is_done(i):
                continue
            got, stolen_from = store.claim(i)
            if not got:
                continue
            if store.is_done(i):             # raced with the finisher
                store.release(i)
                continue
            key = manifest["items"][i]
            if stolen_from is not None:
                shard.event("steal", item=key, id=i, prev=stolen_from)
            # A kill here dies holding the lease with no result: the
            # mid-bucket worker death the protocol must absorb.
            faults.hit("dist.item")
            val, flag = probe_engine.probe_segment(
                host, by_key[key].seg, params, oracle,
                probe_config=cfg, stats=stats)
            store.renew(i)
            shard.put(key, None if val is None else float(val), flag)
            store.mark_done(i)
            faults.hit("dist.done")
            store.release(i)
            completed += 1
            progressed = True
        if not progressed:
            if time.monotonic() > deadline:
                raise DistBuildError(
                    "worker deadline exceeded with items still leased "
                    "elsewhere")
            time.sleep(poll_s)


# ---------------------------------------------------------------------------
# The coordinator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistReport:
    """What the fan-out did: who completed what, who died, what was
    reassigned or repaired.  ``dead_workers`` includes stragglers killed
    at shutdown after the build completed without them.  The port adds
    ``exit_codes`` (each spawned worker's exit status) and
    ``worker_lines`` (each worker's final JSON line from its log: items,
    kernel launches, probe retries and quarantines, start-up seconds;
    None for a worker that printed none)."""

    workers: int = 0
    items: int = 0                     # work items of this build
    journal_prefilled: int = 0         # resumed from the build journal
    completed_by: dict = dataclasses.field(default_factory=dict)
    reassigned: list = dataclasses.field(default_factory=list)
    repaired: list = dataclasses.field(default_factory=list)
    dead_workers: list = dataclasses.field(default_factory=list)
    exit_codes: dict = dataclasses.field(default_factory=dict)
    worker_lines: dict = dataclasses.field(default_factory=dict)
    corrupt_records: int = 0
    coordinator_items: int = 0         # inline fallback runs
    cache_hit: bool = False
    wall_s: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def worker_log_path(work_dir: str, w: int) -> str:
    """Worker ``w``'s combined stdout and stderr: the first place to look
    when it is in ``DistReport.dead_workers``."""
    return os.path.join(work_dir, "logs", f"w{w}.log")


def worker_line(work_dir: str, w: int) -> dict | None:
    """Worker ``w``'s final JSON line (its summary), or None."""
    try:
        with open(worker_log_path(work_dir, w)) as f:
            lines = f.read().splitlines()
    except OSError:
        return None
    for ln in reversed(lines):
        if ln.startswith("{"):
            try:
                return json.loads(ln)
            except ValueError:
                return None
    return None


def _spawn_worker(work_dir: str, w: int, workers: int, host_spec: dict,
                  oracle, probe_config, *, engine: str, method: str,
                  lease_s: float, deadline_s: float, device):
    from repro_torch.launch.distributed import worker_env
    from repro_torch.testing.subproc import REPO_ROOT

    env = worker_env(w, workers, device=device,
                     faults_spec=faults.worker_env_spec(w))
    argv = [sys.executable, "-m", WORKER_MODULE, "--worker",
            "--dir", work_dir, "--worker-id", str(w),
            "--host-spec", json.dumps(host_spec),
            "--oracle-spec", json.dumps(oracle_spec(oracle)),
            "--engine", engine, "--method", method,
            "--lease-s", str(lease_s), "--deadline-s", str(deadline_s),
            "--spawned-at", repr(time.time())]
    ps = probe_spec(probe_config)
    if ps:
        argv += ["--probe-spec", json.dumps(ps)]
    log_path = worker_log_path(work_dir, w)
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    log = open(log_path, "w")
    proc = subprocess.Popen(argv, env=env, cwd=REPO_ROOT, stdout=log,
                            stderr=subprocess.STDOUT, text=True)
    proc._log_file = log
    return proc


def _reap(proc, grace_s: float) -> int:
    try:
        proc.communicate(timeout=grace_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
    log = getattr(proc, "_log_file", None)
    if log is not None:
        log.close()
    return proc.returncode


def dist_build_tables(host, *, cache_dir: str, workers: int = 2,
                      host_spec: dict | None = None,
                      method: str = "layermerge", latency_oracle=None,
                      importance="magnitude", base_perf=None, params=None,
                      prune: bool = True, engine: str = "batched",
                      probe_config=None, resume: bool = True,
                      progress=None, work_dir: str | None = None,
                      lease_s: float = 30.0, poll_s: float = 0.2,
                      deadline_s: float = 600.0,
                      serial_spawn: bool = False,
                      worker_device="cuda",
                      keep_work_dir: bool = False):
    """Build tables with the latency probes fanned out over ``workers``
    subprocesses; ``(Tables, DistReport)``.

    The flow: enumerate the work items → skip those already in the build
    journal (a resume) → publish the manifest → spawn the workers (each
    with a non-zero process index, so
    :func:`repro_torch.launch.distributed.is_main` gates them out of
    every publish) on ``worker_device`` (the card by default; 'cpu' hides
    it) → wait for the done markers or the workers' exits → run leftovers
    inline → merge the shards → append the merged records to the real
    build journal in one fsync → finish through
    ``build_tables(resume=True)``, whose journal replay makes the result
    the records' tables: bitwise a single-process build under the
    analytic oracle.

    Needs a content-addressable build (``host.fingerprint`` and a
    nameable importance): the merge lands under the build's cache key.
    Measured-importance probes run in the coordinator inside the final
    ``build_tables``; only the latency column fans out.  ``workers=0`` is
    the local build.  ``serial_spawn`` starts worker ``w+1`` only after
    worker ``w`` exited, which makes a kill and its steal deterministic.
    A cache hit hands a wall-clock build's timings to the oracle, as
    ``build_tables`` does.  The work directory is removed after the build
    unless ``keep_work_dir`` or a worker died (its log is kept).
    """
    oracle = latency_oracle or AnalyticOracle()
    key = table_cache.cache_key(host, oracle, method, importance,
                                prune=prune, base_perf=base_perf,
                                engine=engine)
    if key is None:
        raise DistBuildError(
            "distributed builds require a content-addressable cache key "
            "(host.fingerprint + nameable importance): worker results "
            "merge through the build journal under that key")
    report = DistReport(workers=workers)
    t0 = time.perf_counter()

    cached = table_cache.load(cache_dir, key)
    if cached is not None:
        table_cache.discard_journal(cache_dir, key)
        if isinstance(oracle, WallClockOracle):
            _hand_back_timings(host, method, oracle, cached.timings)
        report.cache_hit = True
        report.wall_s = time.perf_counter() - t0
        return cached, report
    if not resume:
        table_cache.discard_journal(cache_dir, key)
    journal = table_cache.BuildJournal(cache_dir, key)

    items = latency_work_items(host, method=method, engine=engine)
    report.items = len(items)
    todo = [it for it in items if journal.get(it.key) is None]
    report.journal_prefilled = len(items) - len(todo)

    wd = None
    if todo and workers > 0:
        if host_spec is None:
            raise DistBuildError(
                'spawning workers requires host_spec ({"factory": '
                '"module:function", "kwargs": {...}})')
        # Absolute: workers run in the repo root, where a relative
        # coordinator path would name another directory.
        wd = os.path.abspath(work_dir
                             or os.path.join(cache_dir, f"dist_{key[:16]}"))
        os.makedirs(wd, exist_ok=True)
        fp_fn = getattr(host, "fingerprint", None)
        manifest = write_manifest(wd, key, todo, engine=engine,
                                  method=method,
                                  host_fp=fp_fn() if fp_fn else None)
        n = len(manifest["items"])
        store = LeaseStore(wd, "coord", lease_s)

        def spawn(w):
            return _spawn_worker(
                wd, w, workers, host_spec, oracle, probe_config,
                engine=engine, method=method, lease_s=lease_s,
                deadline_s=deadline_s, device=worker_device)

        rcs: dict[int, int] = {}
        deadline = time.monotonic() + deadline_s
        if serial_spawn:
            for w in range(workers):
                if store.count_done(n) == n:
                    break
                rcs[w] = _reap(spawn(w), deadline_s)
        else:
            procs = {w: spawn(w) for w in range(workers)}
            while store.count_done(n) < n:
                if all(p.poll() is not None for p in procs.values()):
                    break
                if time.monotonic() > deadline:
                    for p in procs.values():
                        if p.poll() is None:
                            p.kill()
                    break
                time.sleep(poll_s)
            for w, p in procs.items():
                rcs[w] = _reap(p, grace_s=5.0)
        report.exit_codes = dict(sorted(rcs.items()))
        report.worker_lines = {w: worker_line(wd, w) for w in sorted(rcs)}
        report.dead_workers = sorted(w for w, rc in rcs.items() if rc != 0)
        if progress:
            progress(f"dist: {store.count_done(n)}/{n} items done by "
                     f"{workers} worker(s); dead={report.dead_workers}")

        # Inline fallback: every worker has exited, so a lease still held
        # belongs to a dead worker: run the item regardless.
        cfg = probe_config or probe_engine.ProbeConfig()
        stats = probe_engine.EngineStats(engine=engine)
        coord = ShardJournal(wd, "coord")
        by_key = {it.key: it for it in todo}
        for i, k in enumerate(manifest["items"]):
            if store.is_done(i):
                continue
            holder = store.holder(i)
            if holder and holder != "coord":
                coord.event("steal", item=k, id=i, prev=holder)
            faults.hit("dist.item")
            val, flag = probe_engine.probe_segment(
                host, by_key[k].seg, params, oracle,
                probe_config=cfg, stats=stats)
            coord.put(k, None if val is None else float(val), flag)
            store.mark_done(i)
            report.coordinator_items += 1

        names = [f"w{w}" for w in range(workers)] + ["coord"]
        records, events, corrupt = merge_shards(wd, names)
        report.corrupt_records = corrupt
        # Repair: a done marker is a claim, the shard record the evidence:
        # items marked done whose record was lost or garbled run here.
        for k in manifest["items"]:
            if k in records:
                continue
            val, flag = probe_engine.probe_segment(
                host, by_key[k].seg, params, oracle,
                probe_config=cfg, stats=stats)
            v = None if val is None else float(val)
            coord.put(k, v, flag)
            records[k] = (v, flag, "coord")
            report.repaired.append(k)
        report.reassigned = sorted(
            {e["item"] for e in events if e.get("evt") == "steal"})
        wins: dict[str, int] = {}
        for _v, _p, shard_name in records.values():
            wins[shard_name] = wins.get(shard_name, 0) + 1
        report.completed_by = wins
        journal.put_many(
            [(k,) + records[k][:2] for k in manifest["items"]])

    tables = build_tables(host, method=method, latency_oracle=oracle,
                          importance=importance, base_perf=base_perf,
                          params=params, progress=progress, prune=prune,
                          engine=engine, cache_dir=cache_dir,
                          probe_config=probe_config, resume=True)
    if wd is not None and not keep_work_dir and not report.dead_workers:
        shutil.rmtree(wd, ignore_errors=True)
    report.wall_s = time.perf_counter() - t0
    return tables, report
