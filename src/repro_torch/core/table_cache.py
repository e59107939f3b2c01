"""Content-addressed on-disk cache for the ``T``/``I`` lookup tables, and
the write-ahead journal that makes a table build survive a crash.

The port's copy of the JAX package's ``repro.core.table_cache``, with
its key layout, file names and JSON payload, so a cache file or a
journal written by either package loads in the other.

Keys
----
:func:`cache_key` hashes together:

* the **host fingerprint** (``host.fingerprint()``: structure, boundary
  shapes, probe workload, the parameters' digest and the machine token —
  wall-clock tables do not transfer between cards);
* the **oracle** (:func:`oracle_token`: class name and dataclass fields);
* the **method** and the **importance token** (``"magnitude"``, or an
  :class:`~.importance.ImportanceSpec`'s ``cache_token``: a measured
  spec closes over callables and data, so it is cacheable only when the
  caller names the workload);
* ``prune`` and ``base_perf`` (both change the stored tables), and a
  format version, so an old layout misses instead of mis-parsing.

It is None (no cache) when any part is not content-addressable.  The
engine is left out: the batched and sequential builds agree, so either
serves the other.

Crash contract
--------------
* **Write-ahead journal** — while a cacheable build runs, every
  completed probe bucket appends one record ``{"k": key, "v": value,
  "p": provenance}`` to ``tables_<key>.journal`` (:class:`BuildJournal`,
  fsync'd through :func:`repro_torch.checkpoint.ckpt.
  append_journal_line`).  Keys: ``latb:<repr of the shape signature>``
  (a latency bucket, under either engine: the port times once per
  signature) and ``imp:<i>:<j>:<k>`` (an importance probe).  A killed
  build resumes from the journal: journaled buckets are not probed
  again, and their floats (JSON round-trips doubles exactly) seed the
  wall-clock oracle before anything is timed, so the resumed tables and
  the ``T_orig`` computed after them read the journal's values;
  quarantined buckets re-derive the deterministic analytic estimate.
  The journal is deleted only after the tables are published.
* **Torn appends** — a record without its newline is truncated away
  before the journal is parsed or appended to.
* **Quarantine on load** — a torn, corrupt or unparsable cache file is
  renamed to ``<file>.corrupt`` (:func:`quarantine`) and read as a miss;
  the rebuild publishes under the original name.  An old format version
  is a plain miss.
* **Timings** — a wall-clock build's cache file also holds the seconds
  of every signature it timed (``"timings"``, a field the JAX package's
  reader ignores); a cache hit seeds the oracle with them, so ``T_orig``
  reads the cached timings and nothing is timed again.
* **At-most-once publish** — publishes and journal appends are gated on
  :func:`is_main`.
"""
from __future__ import annotations

import hashlib
import json
import os
import platform

import numpy as np
import torch

from repro_torch.launch.distributed import is_main as _dist_is_main
from repro_torch.testing import faults

from .latency import oracle_token

FORMAT_VERSION = 2


def is_main() -> bool:
    """True in the process that publishes caches and journals
    (:func:`repro_torch.launch.distributed.is_main`: process index 0).
    A distributed build's workers are not: they write only their shards."""
    return _dist_is_main()


def _leaves(tree, path: str = ""):
    """``(path, leaf)`` pairs in the JAX package's flatten order (dict
    keys sorted), each path in its ``keystr`` form: ``['layers'][0]['w']``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def pytree_digest(tree) -> str:
    """sha256 over every leaf's path, dtype, shape and raw bytes — the JAX
    package's digest of the same values.  Leaves are copied to the host
    one at a time."""
    h = hashlib.sha256()
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            arr = leaf.detach().cpu().numpy()
        else:
            arr = np.asarray(leaf)
        h.update(path.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        # the bytes of ``tobytes()``, hashed in place (no copy)
        h.update(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    return h.hexdigest()


def machine_token(device) -> str:
    """Identity of the timing machine — wall-clock tables do not transfer:
    ``<machine>|cuda|<card name>`` on the card, ``<machine>|cpu|cpu`` on
    the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "|".join((platform.machine(), "cuda",
                         torch.cuda.get_device_name(dev)))
    return "|".join((platform.machine(), "cpu", "cpu"))


def importance_token(importance) -> str | None:
    """Stable name of the importance workload, or None (not cacheable).

    A measured spec's ``cache_token`` names its closures and data; the
    fine-tune's hyperparameters are folded in here, so changing
    ``steps``, ``lr`` or ``normalize_by_base`` under one token misses."""
    if isinstance(importance, str):
        return importance
    token = getattr(importance, "cache_token", None)
    if token is None:
        return None
    return "|".join((token, f"steps={importance.steps}",
                     f"lr={importance.lr!r}",
                     f"norm={importance.normalize_by_base}"))


def cache_key(host, oracle, method: str, importance, *, prune: bool = True,
              base_perf: float | None = None,
              engine: str = "batched") -> str | None:
    """Digest of every table-build input, or None when not addressable.
    ``engine`` is left out (either engine's build serves the other)."""
    fp_fn = getattr(host, "fingerprint", None)
    imp = importance_token(importance)
    if fp_fn is None or imp is None:
        return None
    h = hashlib.sha256()
    h.update(f"v{FORMAT_VERSION}".encode())
    h.update(fp_fn().encode())
    h.update(oracle_token(oracle).encode())
    h.update(method.encode())
    h.update(imp.encode())
    h.update(repr((bool(prune), base_perf)).encode())
    return h.hexdigest()


def _key_sort(k) -> tuple[int, str]:
    """Sort key over mixed ``k`` / ``(k, mode)`` option keys (the cache
    holds fp tables; precision siblings are derived after the publish)."""
    if isinstance(k, tuple):
        return int(k[0]), str(k[1])
    return int(k), ""


def _path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"tables_{key}.json")


def quarantine(path: str) -> str | None:
    """Move a corrupt file out of the read path to ``<path>.corrupt``
    (numbered suffixes keep earlier evidence); the destination, or None
    when the file is gone or cannot be moved."""
    base = path + ".corrupt"
    dst, n = base, 0
    while os.path.exists(dst):
        n += 1
        dst = f"{base}.{n}"
    try:
        os.replace(path, dst)
    except OSError:
        return None
    return dst


def save(cache_dir: str, key: str, tables) -> str:
    """Atomically publish built :class:`~.tables.Tables` (fault point
    ``table_cache.publish`` first); only :func:`is_main` writes."""
    from repro_torch.checkpoint.ckpt import atomic_write_text

    path = _path(cache_dir, key)
    if not is_main():
        return path
    payload = {
        "format": FORMAT_VERSION,
        "build_seconds_latency": tables.build_seconds_latency,
        "build_seconds_importance": tables.build_seconds_importance,
        "num_pruned": tables.num_pruned,
        "stats": tables.stats.as_dict() if tables.stats else None,
        "provenance": [{"i": i, "j": j, "k": k, "flag": flag}
                       for (i, j, k), flag
                       in sorted(tables.provenance.items())],
        "spans": [
            {"i": i, "j": j,
             "opts": [{"k": list(k) if isinstance(k, tuple) else k,
                       "imp": imp, "lat": lat, "kept": list(kept)}
                      for k, (imp, lat, kept)
                      in sorted(row.items(), key=lambda kv: _key_sort(kv[0]))]}
            for (i, j), row in sorted(tables.entries.items())
        ],
        "timings": [{"sig": sig, "v": v, "p": p}
                    for sig, (v, p) in sorted(tables.timings.items())],
    }
    faults.hit("table_cache.publish")
    return atomic_write_text(path, json.dumps(payload))


def load(cache_dir: str, key: str):
    """Cached :class:`~.tables.Tables`, or None on a miss; a torn or
    corrupt file is quarantined and read as a miss."""
    from .probe_engine import EngineStats
    from .tables import Tables

    path = _path(cache_dir, key)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            payload = json.load(f)
        if payload.get("format") != FORMAT_VERSION:
            return None                       # valid but stale: plain miss
        entries = {
            (sp["i"], sp["j"]): {
                (tuple(o["k"]) if isinstance(o["k"], list) else o["k"]):
                    (o["imp"], o["lat"], tuple(o["kept"]))
                for o in sp["opts"]}
            for sp in payload["spans"]
        }
        provenance = {(p["i"], p["j"], p["k"]): p["flag"]
                      for p in payload.get("provenance", [])}
        timings = {t["sig"]: (t["v"], t["p"])
                   for t in payload.get("timings", [])}
        stats = EngineStats(**payload["stats"]) if payload.get("stats") \
            else EngineStats()
        tables = Tables(entries=entries,
                        build_seconds_latency=payload[
                            "build_seconds_latency"],
                        build_seconds_importance=payload[
                            "build_seconds_importance"],
                        num_pruned=payload["num_pruned"], stats=stats,
                        provenance=provenance, timings=timings)
    except (OSError, json.JSONDecodeError, KeyError, TypeError, ValueError):
        quarantine(path)                      # torn or corrupt: a miss
        return None
    stats.cache_hit = True
    return tables


# ---------------------------------------------------------------------------
# Write-ahead journal for resumable builds
# ---------------------------------------------------------------------------

def journal_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"tables_{key}.journal")


def discard_journal(cache_dir: str, key: str) -> None:
    """Remove a journal that is no longer needed (its tables are
    published, or a crash came between publish and cleanup)."""
    try:
        os.remove(journal_path(cache_dir, key))
    except OSError:
        pass


class BuildJournal:
    """Append-only record of the completed probe buckets of one build key.

    ``get(key)`` is the journaled ``(value, provenance)`` (None on a
    miss); ``put`` durably appends one record (once it returns, the
    bucket survives a SIGKILL).  A record torn by a crash is truncated
    away on open; a complete but unparsable one is skipped."""

    def __init__(self, cache_dir: str, key: str):
        from repro_torch.checkpoint.ckpt import read_journal_lines

        self.path = journal_path(cache_dir, key)
        self._records: dict[str, tuple] = {}
        for line in read_journal_lines(self.path):
            try:
                rec = json.loads(line)
                self._records[rec["k"]] = (rec["v"], rec.get("p", "measured"))
            except (json.JSONDecodeError, KeyError, TypeError):
                continue

    def __len__(self) -> int:
        return len(self._records)

    def get(self, key: str) -> tuple | None:
        return self._records.get(key)

    def put(self, key: str, value, provenance: str = "measured") -> None:
        from repro_torch.checkpoint.ckpt import append_journal_line

        if is_main():
            append_journal_line(self.path, json.dumps(
                {"k": key, "v": value, "p": provenance}))
        self._records[key] = (value, provenance)

    def put_many(self, records) -> int:
        """Durably append many ``(key, value, provenance)`` records in one
        fsync, skipping keys already journaled; the number appended."""
        fresh = [(k, v, p) for k, v, p in records if k not in self._records]
        if fresh and is_main():
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            data = b"".join(
                (json.dumps({"k": k, "v": v, "p": p}) + "\n").encode()
                for k, v, p in fresh)
            with open(self.path, "ab") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
        for k, v, p in fresh:
            self._records[k] = (v, p)
        return len(fresh)

    def discard(self) -> None:
        try:
            os.remove(self.path)
        except OSError:
            pass
