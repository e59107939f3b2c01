"""Lookup-table construction — ``T[i,j,k]`` and ``I[i,j,k]`` (paper §3.2).

Tables are built against a *host* exposing the network to the generic
machinery: ``descs()``, ``enumerator(method)``, ``segment_cost(seg)``,
``probe_signature(seg)``, ``segment_probe(seg, params)`` and
``original_k(l)`` (see :class:`repro_torch.models.cnn_host.CNNHost`).

A metadata-only pass enumerates every ``(i, j, k)`` probe; the latency
column goes through :mod:`.probe_engine` (one measurement per shape
signature), the importance column is the magnitude proxy, and options
Pareto-dominated within their span are dropped before the DP sees them.
"""
from __future__ import annotations

import dataclasses
import time

from . import probe_engine
from .dp import TableFn
from .importance import magnitude_importance
from .latency import AnalyticOracle, LatencyOracle
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


def build_tables(
    host,
    *,
    method: str = "layermerge",
    latency_oracle: LatencyOracle | None = None,
    params=None,
) -> Tables:
    """Construct both lookup tables for ``host`` (Algorithm 2, lines 1-8)
    with the magnitude importance proxy (the Eq. 4 fine-tune is ROADMAP
    queue 1)."""
    oracle = latency_oracle or AnalyticOracle()
    enum = host.enumerator(method)
    total_value = sum(d.value for d in enum.descs)
    stats = probe_engine.EngineStats()
    probes = enumerate_probes(host, method, enum=enum)

    t0 = time.perf_counter()
    lats = probe_engine.measure_latencies(
        host, [p[5] for p in probes], oracle, params, stats=stats)
    t_lat = time.perf_counter() - t0

    t0 = time.perf_counter()
    entries: dict = {}
    for (i, j, k, val, kept, seg), lat in zip(probes, lats):
        imp = 1.0 if seg.original else magnitude_importance(
            val, max(total_value, 1e-9), len(seg.pruned))
        entries.setdefault((i, j), {})[k] = (imp, lat, kept)
    t_imp = time.perf_counter() - t0

    entries, dropped = pareto_prune(entries)
    return Tables(entries=entries, build_seconds_latency=t_lat,
                  build_seconds_importance=t_imp, num_pruned=dropped,
                  stats=stats)


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
