"""Lookup-table construction — ``T[i,j,k]`` and ``I[i,j,k]`` (paper §3.2).

Tables are built against a *host* exposing the network to the generic
machinery: ``descs()``, ``enumerator(method)``, ``segment_cost(seg)``,
``probe_signature(seg)``, ``segment_probe(seg, params)``,
``original_k(l)`` and ``fingerprint()`` (see
:class:`repro_torch.models.cnn_host.CNNHost`).

A metadata-only pass enumerates every ``(i, j, k)`` probe; the latency
column goes through :mod:`.probe_engine` (one measurement per shape
signature), the importance column is the magnitude proxy or the paper's
Eq. 4 fine-tune (an :class:`~.importance.ImportanceSpec`, through the
engine's vmapped span batches), and options Pareto-dominated within
their span are dropped before the DP sees them.
With ``quantize`` each span's row is then widened with derived ``(k,
mode)`` precision siblings (:func:`quant_sibling_entries`).

With a ``cache_dir`` a build is content-addressed, journaled while it
runs and resumable after a crash (:mod:`.table_cache`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from . import probe_engine, table_cache
from .dp import TableFn
from .importance import ImportanceSpec, magnitude_importance
from .latency import AnalyticOracle, LatencyOracle, WallClockOracle
from .plan import CompressionPlan, Segment
from .segments import pareto_prune_options


@dataclasses.dataclass
class Tables:
    """Materialized (i, j) → {k: (I, T, kept)} with build metadata."""

    entries: dict[tuple[int, int], dict[int, tuple[float, float, tuple[int, ...]]]]
    build_seconds_latency: float = 0.0
    build_seconds_importance: float = 0.0
    num_pruned: int = 0              # options dropped by Pareto dominance
    stats: probe_engine.EngineStats | None = None
    # (i, j, k) -> "retimed" / "quarantined" for the latency entries that
    # were not clean first measurements (kept entries only).
    provenance: dict = dataclasses.field(default_factory=dict)
    # repr(signature) -> (seconds or None, flag) of a wall-clock build:
    # what a cache hit hands back to the oracle.
    timings: dict = dataclasses.field(default_factory=dict)

    @property
    def num_entries(self) -> int:
        return sum(len(v) for v in self.entries.values())

    def fn(self) -> TableFn:
        return lambda i, j: self.entries.get((i, j), {})


def pareto_prune(entries) -> tuple[dict, int]:
    """Per-span Pareto-dominance pruning (optimum-preserving for the DP);
    returns ``(pruned, #dropped)``."""
    out: dict = {}
    dropped = 0
    for span, opts in entries.items():
        row = pareto_prune_options(opts)
        dropped += len(opts) - len(row)
        out[span] = row
    return out, dropped


# Relative importance penalty of a precision sibling: strictly below its fp
# twin, so the DP keeps fp while the budget is slack and trades precision
# only when latency binds (the pair is mutually non-dominated).
QUANT_IMPORTANCE_PENALTY = 1e-4


def quant_sibling_entries(host, entries, quantize: str,
                          ratio_oracle: AnalyticOracle | None = None
                          ) -> tuple[dict, int]:
    """Widen each span's candidate row with ``(k, mode)`` precision
    siblings; returns ``(entries, #added)``.

    Each fp entry whose segment the host can quantize
    (``host.segment_cost(seg, quant=mode)`` is not ``None``) gains one
    sibling keyed ``(k, mode)``, kept only when it is predicted faster:

    * ``T_q = T_fp × (analytic quantized / analytic fp latency)`` — the
      measured fp latency keeps its measurement and only the relative
      effect of the narrow bytes is modelled, by ``ratio_oracle`` (the
      H100 roofline by default; the parity tests pass the JAX package's
      constants);
    * ``I_q = I_fp − |I_fp|·penalty − ε`` (strictly below the fp twin).

    Siblings are derived, never probed: the probes stay fp-only.
    """
    if not quantize or quantize == "none":
        return entries, 0
    from repro_torch.kernels.quant import MODES
    if quantize not in MODES:
        raise ValueError(f"unknown quantization mode {quantize!r}")
    ora = ratio_oracle or AnalyticOracle()
    added = 0
    out: dict = {}
    for (i, j), row in entries.items():
        new_row = dict(row)
        for key, (imp, lat, kept) in row.items():
            if isinstance(key, tuple):
                continue                      # already a sibling
            seg = Segment(i=i, j=j, k=key, kept=kept)
            cost_q = host.segment_cost(seg, quant=quantize)
            if cost_q is None:
                continue
            lat_f = ora.segment_latency(host.segment_cost(seg))
            lat_q = ora.segment_latency(cost_q)
            if not lat_q < lat_f:
                continue                      # no predicted win, no sibling
            imp_q = imp - abs(imp) * QUANT_IMPORTANCE_PENALTY - 1e-12
            new_row[(key, quantize)] = (imp_q, lat * (lat_q / lat_f), kept)
            added += 1
        out[(i, j)] = new_row
    return out, added


def with_quant_siblings(tables: Tables, host, quantize: str | None,
                        ratio_oracle: AnalyticOracle | None = None
                        ) -> Tables:
    """``tables`` widened with precision siblings (itself for fp)."""
    if not quantize or quantize == "none":
        return tables
    entries, _ = quant_sibling_entries(host, tables.entries, quantize,
                                       ratio_oracle)
    return dataclasses.replace(tables, entries=entries)


def build_tables(
    host,
    *,
    method: str = "layermerge",
    latency_oracle: LatencyOracle | None = None,
    importance: ImportanceSpec | str = "magnitude",
    base_perf: float | None = None,
    params=None,
    progress: Callable[[str], None] | None = None,
    prune: bool = True,
    engine: str = "batched",
    cache_dir: str | None = None,
    probe_config: probe_engine.ProbeConfig | None = None,
    resume: bool = True,
    quantize: str | None = None,
    ratio_oracle: AnalyticOracle | None = None,
) -> Tables:
    """Construct both lookup tables for ``host`` (Algorithm 2, lines 1-8).

    A metadata-only pass enumerates every ``(i, j, k)`` probe; the probe
    engine then fills the latency column (one evaluation per shape
    signature under either engine) and the importance column:
    ``"magnitude"`` (the deterministic proxy) or an
    :class:`ImportanceSpec`, every non-original entry fine-tuned and
    scored against ``base_perf`` (Eq. 4) through
    :func:`.probe_engine.measure_importances` (vmapped span batches under
    ``engine="batched"`` where the host supports them, one scalar
    fine-tune per entry under ``"sequential"``).  Original entries are
    1.0 (``exp(0)``).  With ``prune`` (the default) options
    Pareto-dominated within their span are dropped — optimum-preserving
    for the DP.

    ``cache_dir``: a content-addressed hit returns the cached tables
    (and hands a wall-clock build's timings to the oracle) and discards a
    stale journal.  A miss journals every completed bucket, publishes the
    tables, and only then discards the journal; with ``resume`` (the
    default) a killed build replays its journal and gives tables
    bitwise the uninterrupted build's, ``resume=False`` discards the
    journal first (:mod:`.table_cache`).  ``probe_config``: the
    wall-clock hardening policy (:class:`.probe_engine.ProbeConfig`);
    flags other than "measured" land in ``Tables.provenance`` and ride
    the cache and the artifact.

    ``quantize`` ('int8' / 'w8a8') widens the pruned fp rows with
    precision siblings priced by ``ratio_oracle``
    (:func:`quant_sibling_entries`) after the fp-only publish, so the
    cache and the journal never hold siblings; None / 'none' leaves the
    tables bit-identical to an fp-only build."""
    oracle = latency_oracle or AnalyticOracle()
    wallclock = isinstance(oracle, WallClockOracle)

    key = journal = None
    if cache_dir is not None:
        key = table_cache.cache_key(host, oracle, method, importance,
                                    prune=prune, base_perf=base_perf,
                                    engine=engine)
        if key is not None:
            cached = table_cache.load(cache_dir, key)
            if cached is not None:
                # a journal outlives a publish only when the build crashed
                # between publish and cleanup: the tables subsume it
                table_cache.discard_journal(cache_dir, key)
                if wallclock:
                    _hand_back_timings(host, method, oracle, cached.timings)
                if progress:
                    progress(f"tables: cache hit ({cached.num_entries} "
                             "entries)")
                return with_quant_siblings(cached, host, quantize,
                                           ratio_oracle)
            if not resume:
                table_cache.discard_journal(cache_dir, key)
            journal = table_cache.BuildJournal(cache_dir, key)
            if progress and len(journal):
                progress(f"tables: resuming from journal "
                         f"({len(journal)} completed probes)")

    enum = host.enumerator(method)
    total_value = sum(d.value for d in enum.descs)
    stats = probe_engine.EngineStats(engine=engine)
    probes = enumerate_probes(host, method, enum=enum)
    segs = [p[5] for p in probes]

    t0 = time.perf_counter()
    prov_flags = [probe_engine.PROBE_MEASURED] * len(probes)
    lats = probe_engine.measure_latencies(
        host, segs, oracle, params, engine=engine, stats=stats,
        progress=progress, journal=journal, probe_config=probe_config,
        provenance=prov_flags)
    t_lat = time.perf_counter() - t0

    # importance column: analytic entries inline, measured ones through
    # the engine
    t0 = time.perf_counter()
    imps: list[float | None] = [None] * len(probes)
    measured: list[int] = []
    for n, (i, j, k, val, kept, seg) in enumerate(probes):
        if seg.original:
            imps[n] = 1.0                  # exp(0): untouched layer
        elif importance == "magnitude":
            imps[n] = magnitude_importance(val, max(total_value, 1e-9),
                                           len(seg.pruned))
        else:
            measured.append(n)
    if measured:
        vals = probe_engine.measure_importances(
            host, [segs[n] for n in measured], importance,
            base_perf or 0.0, params, engine=engine, stats=stats,
            progress=progress, journal=journal)
        for n, v in zip(measured, vals):
            imps[n] = v
    t_imp = time.perf_counter() - t0

    entries: dict = {}
    for (i, j, k, val, kept, seg), lat, imp in zip(probes, lats, imps):
        entries.setdefault((i, j), {})[k] = (imp, lat, kept)
    dropped = 0
    if prune:
        entries, dropped = pareto_prune(entries)
    # provenance survives pruning only for entries the DP can still see
    provenance = {
        (i, j, k): flag
        for (i, j, k, *_), flag in zip(probes, prov_flags)
        if flag != probe_engine.PROBE_MEASURED
        and k in entries.get((i, j), {})
    }
    timings = {}
    if wallclock:                          # every signature is held now
        for seg in segs:
            sig = probe_engine._signature(host, seg)
            timings[repr(sig)] = oracle.recall(sig)

    tables = Tables(entries=entries, build_seconds_latency=t_lat,
                    build_seconds_importance=t_imp, num_pruned=dropped,
                    stats=stats, provenance=provenance, timings=timings)
    if key is not None:
        table_cache.save(cache_dir, key, tables)
        # only after a durable publish is the journal redundant
        table_cache.discard_journal(cache_dir, key)
    return with_quant_siblings(tables, host, quantize, ratio_oracle)


def _hand_back_timings(host, method: str, oracle: WallClockOracle,
                       timings: dict) -> None:
    """Seed ``oracle`` with a cached build's timings (keyed by the
    signatures' reprs), so whatever it prices next — ``T_orig`` — reads
    the cached seconds and nothing is timed again."""
    for *_, seg in enumerate_probes(host, method):
        sig = probe_engine._signature(host, seg)
        if repr(sig) in timings:
            oracle.remember(sig, *timings[repr(sig)], timed=False)


def enumerate_probes(host, method: str = "layermerge", enum=None):
    """Metadata-only enumeration of every ``(i, j, k)`` probe as
    ``(i, j, k, value, kept, Segment)``."""
    enum = enum or host.enumerator(method)
    probes = []
    for i, j, opts in enum.all_spans():
        for k, (val, kept) in opts.items():
            seg = Segment(i=i, j=j, k=k, kept=kept,
                          original=(j - i == 1 and k == host.original_k(j)
                                    and set(kept) == set(seg_layers(i, j))))
            probes.append((i, j, k, val, kept, seg))
    return probes


def seg_layers(i: int, j: int) -> tuple[int, ...]:
    return tuple(range(i + 1, j + 1))


def one_segment_plan(host, seg: Segment) -> CompressionPlan:
    """Ã_ij / C̃_ijk of Eq. 4: everything original except segment (i, j]."""
    L = len(host.descs())
    segs = [Segment(i=l - 1, j=l, k=host.original_k(l), kept=(l,),
                    original=True) for l in range(1, seg.i + 1)]
    segs.append(seg)
    segs += [Segment(i=l - 1, j=l, k=host.original_k(l), kept=(l,),
                     original=True) for l in range(seg.j + 1, L + 1)]
    return CompressionPlan(num_layers=L, segments=tuple(segs),
                           method="probe")
