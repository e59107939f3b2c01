"""The probe engine: ``T[i,j,k]`` latency probes bucketed by shape
signature, and ``I[i,j,k]`` Eq. 4 fine-tunes in vmapped span batches.

Latency depends on a merged segment's shapes only — never on its weight
values — so every probe is bucketed by ``host.probe_signature(seg)`` and
one representative per bucket is measured; the value is attributed to
every entry of the bucket.  Under the wall-clock oracle that is one
prepare (the probe built and run once) and one timing on the card per
distinct signature, held by the oracle (:meth:`~.latency.WallClockOracle.
recall`), so a signature is timed once per oracle under either engine.

Importance (:func:`measure_importances`): hosts that implement
``importance_batch`` hand the engine one shared ``apply_fn`` plus stacked
candidate params for a span's probes, and the few-step Adam fine-tune
runs vmapped over the probe axis
(:func:`~.importance.adam_finetune_batched`); everything else runs one
scalar fine-tune per probe.

Crash safety (a table build of a large network is a long job):

* **Write-ahead journal** — with ``journal=`` (a
  :class:`~.table_cache.BuildJournal`) every completed bucket or probe is
  durably recorded before the build moves on, and a killed build resumes
  from the journal bit-identically (the contract is in
  :mod:`.table_cache`).  A journaled latency seeds the wall-clock oracle,
  so whatever the oracle prices afterwards (``T_orig``) reads it too.
* **Probe hardening** (:class:`ProbeConfig`) — each wall-clock probe has
  a post-hoc time budget, bounded retries with exponential backoff and
  re-timing of a noisy measurement; a bucket that keeps failing is
  **quarantined** to the deterministic :class:`~.latency.AnalyticOracle`
  estimate, with provenance ``"quarantined"`` in the tables (and from
  there the cache and the artifact).
* **Fault points** — ``probe.prepare``, ``probe.time``,
  ``tables.bucket`` and ``tables.importance``
  (:mod:`repro_torch.testing.faults`).

Two deliberate differences from the JAX package (ROADMAP.md queue 3):
the sequential engine, too, times once per signature and journals
``latb:`` keys (not ``lat:i:j:k`` per entry; a ``lat:`` record is
replayed for its bucket); and no worker thread
prepares the next bucket while one is timed — there is no XLA compile
to hide, and a probe built on one thread while another captures a CUDA
graph would break the capture.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import torch
from torch.utils import _pytree as pytree

from repro_torch.testing import faults

from .importance import (adam_finetune_batched, measure_importance,
                         perf_to_importance)
from .latency import AnalyticOracle, LatencyOracle, WallClockOracle
from .plan import Segment

ENGINES = ("batched", "sequential")

# Provenance flags of latency entries (``Tables.provenance`` records the
# ones that are not "measured").
PROBE_MEASURED = "measured"        # the configured oracle's own value
PROBE_RETIMED = "retimed"          # a noisy timing was taken again
PROBE_QUARANTINED = "quarantined"  # persistent failure: analytic estimate


class ProbeTimeout(RuntimeError):
    """A probe ran over its time budget."""


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    """Hardening policy of wall-clock latency probes.

    ``timeout_s`` is checked after the fact: a running kernel cannot be
    interrupted, so the prepare (the probe built and run once) and the
    timing (ending in ``torch.cuda.synchronize()``) are each measured on
    ``time.perf_counter()`` and an attempt over budget counts as a
    failure (a straggler).  A failure is retried up to ``retries`` times
    after ``backoff_s · 2^(attempt − 1)`` seconds; a bucket still failing
    is quarantined to the deterministic estimate of ``fallback_oracle``
    (default: the H100 :class:`~.latency.AnalyticOracle`) with provenance
    ``"quarantined"`` — unless ``quarantine=False``, which raises the
    last error.  ``outlier_rel_spread`` bounds the oracle's relative
    spread; a noisier timing is taken once more and tagged ``"retimed"``.
    """

    timeout_s: float | None = None
    retries: int = 2
    backoff_s: float = 0.05
    outlier_rel_spread: float | None = 1.0
    quarantine: bool = True
    fallback_oracle: LatencyOracle | None = None

    def fallback(self) -> LatencyOracle:
        return self.fallback_oracle or AnalyticOracle()


@dataclasses.dataclass(frozen=True)
class ProbeCallable:
    """One latency probe: ``fn(*args)`` runs the merged segment."""

    fn: Callable
    args: tuple

    def __call__(self):
        return self.fn(*self.args)


@dataclasses.dataclass
class EngineStats:
    """Build accounting surfaced through ``Tables.stats`` (the JAX
    package's fields, so a cache file's stats load in either package)."""

    engine: str = "batched"
    num_latency_probes: int = 0
    num_latency_buckets: int = 0
    num_compiles: int = 0            # probes prepared (built and run once)
    num_timings: int = 0             # timings run on the card
    num_importance_probes: int = 0
    num_importance_batches: int = 0      # vmapped span batches run
    num_importance_sequential: int = 0   # scalar fine-tunes run
    cache_hit: bool = False
    num_journal_hits: int = 0        # buckets or probes replayed
    num_probe_retries: int = 0       # failed attempts retried
    num_retimed: int = 0             # noisy timings taken again
    num_quarantined: int = 0         # buckets given the analytic estimate

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _signature(host, seg: Segment):
    """Bucketing key of ``seg``."""
    return host.probe_signature(seg)


def _prepare_probe(host, seg: Segment, params):
    """The probe of ``seg``, built and run once (synchronised)."""
    call = host.segment_probe(seg, params)
    call()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return call


def _prepare_guarded(host, seg: Segment, params):
    """One prepare attempt: ``(probe, seconds it took)``.  The fault
    point is inside the measured window, so an injected delay reads as a
    slow prepare."""
    t0 = time.perf_counter()
    faults.hit("probe.prepare")
    call = _prepare_probe(host, seg, params)
    return call, time.perf_counter() - t0


def _backoff(cfg: ProbeConfig, attempt: int, stats: EngineStats) -> None:
    stats.num_probe_retries += 1
    time.sleep(cfg.backoff_s * (2 ** (attempt - 1)))


def _timed_guarded(call, oracle: WallClockOracle, cfg: ProbeConfig,
                   stats: EngineStats, *, warmup: int | None = None):
    """Guarded timing of a prepared probe: ``(seconds or None, flag)``;
    None means the timing kept failing and the bucket is quarantined
    (``cfg.quarantine=False`` raises instead)."""
    last: Exception | None = None
    for attempt in range(cfg.retries + 1):
        if attempt:
            _backoff(cfg, attempt, stats)
        try:
            t0 = time.perf_counter()
            faults.hit("probe.time")       # inside the measured window
            val, spread = oracle.time_callable_stats(call, warmup=warmup)
            if cfg.timeout_s is not None and \
                    time.perf_counter() - t0 > cfg.timeout_s:
                raise ProbeTimeout(
                    f"timing exceeded the {cfg.timeout_s}s probe budget")
            if cfg.outlier_rel_spread is not None \
                    and spread > cfg.outlier_rel_spread:
                stats.num_retimed += 1
                val2, spread2 = oracle.time_callable_stats(call,
                                                           warmup=warmup)
                return (val2 if spread2 <= spread else val), PROBE_RETIMED
            return val, PROBE_MEASURED
        except Exception as e:           # FaultKill is a BaseException
            last = e
    if not cfg.quarantine:
        raise last
    stats.num_quarantined += 1
    return None, PROBE_QUARANTINED


def _sequential_wallclock(host, seg: Segment, params,
                          oracle: WallClockOracle, cfg: ProbeConfig,
                          stats: EngineStats):
    """Guarded prepare and timing of one probe: ``(seconds or None,
    flag)``.  The prepare runs the probe once, so the timing warms it
    ``oracle.warmup - 1`` more times."""
    last: Exception | None = None
    for attempt in range(cfg.retries + 1):
        if attempt:
            _backoff(cfg, attempt, stats)
        try:
            call, prep_s = _prepare_guarded(host, seg, params)
            if cfg.timeout_s is not None and prep_s > cfg.timeout_s:
                raise ProbeTimeout(
                    f"prepare exceeded the {cfg.timeout_s}s probe budget")
            val, flag = _timed_guarded(call, oracle, cfg, stats,
                                       warmup=max(0, oracle.warmup - 1))
            stats.num_compiles += 1
            stats.num_timings += 1
            return val, flag
        except Exception as e:
            last = e
    if not cfg.quarantine:
        raise last
    stats.num_quarantined += 1
    return None, PROBE_QUARANTINED


def probe_segment(host, seg: Segment, params, oracle: LatencyOracle, *,
                  probe_config: ProbeConfig | None = None,
                  stats: EngineStats | None = None):
    """Measure one segment: ``(value or None, flag)`` as a journal record
    stores them (None: quarantined).  Analytic oracles price the segment;
    wall-clock oracles run the guarded prepare and timing."""
    cfg = probe_config or ProbeConfig()
    stats = stats if stats is not None else EngineStats()
    if isinstance(oracle, WallClockOracle):
        return _sequential_wallclock(host, seg, params, oracle, cfg, stats)
    return oracle.segment_latency(host.segment_cost(seg)), PROBE_MEASURED


def measure_latencies(
    host,
    segs: Sequence[Segment],
    oracle: LatencyOracle,
    params=None,
    *,
    engine: str = "batched",
    stats: EngineStats | None = None,
    progress: Callable[[str], None] | None = None,
    journal=None,
    probe_config: ProbeConfig | None = None,
    provenance: list | None = None,
) -> list[float]:
    """``T`` value for every segment in ``segs`` (order preserved): one
    evaluation per distinct shape signature, in order of first
    appearance, under either engine.

    ``journal``: completed buckets (``latb:<repr(sig)>``) are durably
    recorded and replayed on a resume; a replayed wall-clock value is
    held by the oracle as if timed now.  A bucket with no ``latb:``
    record replays the ``lat:<i>:<j>:<k>`` record of its representative,
    the JAX package's sequential key (a sequential distributed build's
    work items, :func:`~.dist_build.latency_work_items`).  A wall-clock signature the
    oracle already holds is not timed again (it is journaled).
    ``probe_config``: the retry, timeout and quarantine policy
    (wall-clock only).  ``provenance``: an optional caller-owned list of
    ``len(segs)`` filled with each entry's flag.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected {ENGINES}")
    stats = stats if stats is not None else EngineStats(engine=engine)
    cfg = probe_config or ProbeConfig()
    stats.num_latency_probes += len(segs)
    wallclock = isinstance(oracle, WallClockOracle)

    def quarantine_value(seg: Segment) -> float:
        return cfg.fallback().segment_latency(host.segment_cost(seg))

    def journal_get(key: str):
        if journal is None:
            return None
        rec = journal.get(key)
        if rec is not None:
            stats.num_journal_hits += 1
        return rec

    def journal_put(key: str, val, flag: str):
        if journal is not None:
            journal.put(key, None if val is None else float(val), flag)

    def finish_bucket(sig, val, flag):
        per_bucket[sig] = (val, flag)
        journal_put(f"latb:{sig!r}", val, flag)
        faults.hit("tables.bucket")

    buckets: dict = {}                     # sig -> representative, in order
    sigs = []
    for seg in segs:
        sig = _signature(host, seg)
        sigs.append(sig)
        buckets.setdefault(sig, seg)
    stats.num_latency_buckets += len(buckets)

    per_bucket: dict = {}                  # sig -> (value or None, flag)
    for bi, (sig, seg) in enumerate(buckets.items()):
        rec = journal_get(f"latb:{sig!r}")
        if rec is None:                    # the JAX package's sequential key
            rec = journal_get(f"lat:{seg.i}:{seg.j}:{seg.k}")
        if rec is not None:
            per_bucket[sig] = rec
            if wallclock:
                oracle.remember(sig, *rec, timed=False)
            continue
        if not wallclock:
            finish_bucket(sig, oracle.segment_latency(
                host.segment_cost(seg)), PROBE_MEASURED)
            continue
        held = oracle.recall(sig)
        if held is None:
            held = _sequential_wallclock(host, seg, params, oracle, cfg,
                                         stats)
            oracle.remember(sig, *held, timed=held[0] is not None)
        finish_bucket(sig, *held)
        if progress:
            progress(f"latency bucket {bi + 1}/{len(buckets)} "
                     f"({len(segs)} probes)")

    out = []
    for n, (seg, sig) in enumerate(zip(segs, sigs)):
        val, flag = per_bucket[sig]
        if val is None:                    # quarantined: analytic estimate
            val = quarantine_value(seg)
        if provenance is not None:
            provenance[n] = flag
        out.append(val)
    return out


def layer_latencies(
    host,
    oracle: LatencyOracle,
    params=None,
    *,
    engine: str = "batched",
    stats: EngineStats | None = None,
    probe_config: ProbeConfig | None = None,
) -> list[float]:
    """Per-layer latency of the untouched network (one bucketed pass)."""
    segs = [Segment(i=l - 1, j=l, k=host.original_k(l), kept=(l,),
                    original=True)
            for l in range(1, len(host.descs()) + 1)]
    return measure_latencies(host, segs, oracle, params, engine=engine,
                             stats=stats, probe_config=probe_config)


# Single-device vmapped fine-tunes win only while probes are dispatch-
# bound: the shared all-kept graph pays real FLOPs for every Dirac
# stand-in that a scalar probe would simply skip, so once the per-step
# workload is compute-bound, batching buys nothing and costs the pruned
# layers' compute.  Above this many input elements per fine-tune step the
# engine prefers scalar probes.
DISPATCH_BOUND_ELEMS = 65536


def _batching_pays(spec) -> bool:
    if not spec.train_batches:
        return True                       # unsized workload: assume tiny
    elems = sum(leaf.numel() for leaf in
                pytree.tree_leaves(spec.train_batches[0])
                if isinstance(leaf, torch.Tensor))
    return elems <= DISPATCH_BOUND_ELEMS


def measure_importances(
    host,
    segs: Sequence[Segment],
    spec,
    base_perf: float,
    params=None,
    *,
    engine: str = "batched",
    stats: EngineStats | None = None,
    force_batching: bool | None = None,
    progress: Callable[[str], None] | None = None,
    journal=None,
) -> list[float]:
    """Eq. 4 importance for every (non-original) segment in ``segs``.

    ``batched``: segments are grouped by span ``(i, j]`` and handed to
    ``host.importance_batch``; if the host expresses the span's probes as
    one shared ``apply_fn`` over stacked candidate params, the few-step
    Adam fine-tune runs vmapped over the probe axis and each tuned lane
    is scored through ``perf_fn``.  Two cases take the scalar path, as in
    the JAX package, and are counted in ``stats``: a span with a single
    probe, and a span the host declines (``importance_batch`` returns
    None).  Unless ``force_batching`` overrides :func:`_batching_pays`,
    compute-bound workloads run every probe scalar.  A fine-tune that
    raises, raises.

    With a ``journal`` each completed probe is durably recorded
    (``imp:<i>:<j>:<k>``).  On a resume a fully journaled span group is
    replayed without a fine-tune, and a partly journaled one reruns
    whole: the vmap width never changes across a resume, so replayed and
    recomputed lanes are both bitwise the uninterrupted build's.
    """
    from .tables import one_segment_plan   # local import: tables imports us

    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected {ENGINES}")
    stats = stats if stats is not None else EngineStats(engine=engine)
    stats.num_importance_probes += len(segs)
    out: list[float | None] = [None] * len(segs)

    jkeys = [f"imp:{s.i}:{s.j}:{s.k}" for s in segs]
    done: set[int] = set()
    if journal is not None:
        for n, key in enumerate(jkeys):
            rec = journal.get(key)
            if rec is not None:
                out[n] = rec[0]
                done.add(n)
                stats.num_journal_hits += 1

    def journal_put(n: int):
        if journal is not None:
            journal.put(jkeys[n], float(out[n]))

    def sequential(indices):
        for n in indices:
            if n in done:
                continue
            seg = segs[n]
            apply_fn, p = host.replaced_apply(
                one_segment_plan(host, seg), params)
            out[n] = measure_importance(apply_fn, p, spec, base_perf)
            stats.num_importance_sequential += 1
            journal_put(n)
            faults.hit("tables.importance")
            if progress:
                progress(f"importance probe ({seg.i},{seg.j}] k={seg.k}")

    batch_fn = getattr(host, "importance_batch", None)
    use_batches = force_batching if force_batching is not None \
        else _batching_pays(spec)
    if engine == "sequential" or batch_fn is None or not use_batches:
        sequential(range(len(segs)))
        return out

    groups: dict[tuple[int, int], list[int]] = {}
    for n, seg in enumerate(segs):
        groups.setdefault((seg.i, seg.j), []).append(n)
    for span, indices in groups.items():
        if all(n in done for n in indices):
            continue                      # replayed from the journal
        if len(indices) < 2:
            # a vmap of one lane only adds overhead over the scalar probe
            # (and the Dirac stand-ins cost real FLOPs)
            sequential(indices)
            continue
        # A partly journaled group reruns every lane (the same stacked
        # width, so the same values); they overwrite equal records.
        batch = batch_fn([segs[n] for n in indices], params)
        if batch is None:
            done.difference_update(indices)
            sequential(indices)
            continue
        apply_fn, stacked, grad_mask = batch
        tuned = adam_finetune_batched(apply_fn, stacked, spec,
                                      grad_mask=grad_mask)
        stats.num_importance_batches += 1
        for lane, n in enumerate(indices):
            p_n = pytree.tree_map(lambda x: x[lane], tuned)
            perf = spec.perf_fn(apply_fn, p_n, spec.eval_batches)
            out[n] = perf_to_importance(perf, base_perf, spec)
            journal_put(n)
        faults.hit("tables.importance")
        if progress:
            progress(f"importance batch ({span[0]},{span[1]}]: "
                     f"{len(indices)} lanes vmapped")
    return out
