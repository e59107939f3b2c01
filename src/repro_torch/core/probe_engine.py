"""Latency probes for ``T[i,j,k]``, bucketed by shape signature.

Latency depends on a merged segment's shapes only — never on its weight
values — so every probe is bucketed by ``host.probe_signature(seg)`` and
one representative per bucket is measured; the value is attributed to
every entry of the bucket.  Under the wall-clock oracle that is one
warmup + timing loop per distinct signature on the card.  The JAX
package's journal, retries and compile-overlap thread are not ported yet
(ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from .latency import LatencyOracle, WallClockOracle
from .plan import Segment


@dataclasses.dataclass(frozen=True)
class ProbeCallable:
    """One latency probe: ``fn(*args)`` runs the merged segment."""

    fn: Callable
    args: tuple

    def __call__(self):
        return self.fn(*self.args)


@dataclasses.dataclass
class EngineStats:
    """Build accounting surfaced through ``Tables.stats``."""

    num_latency_probes: int = 0
    num_latency_buckets: int = 0
    num_timings: int = 0             # warmup/timing loops run on the card


def _measure(host, seg: Segment, oracle: LatencyOracle, params,
             stats: EngineStats) -> float:
    if isinstance(oracle, WallClockOracle):
        stats.num_timings += 1
        return oracle.time_callable(host.segment_probe(seg, params))
    return oracle.segment_latency(host.segment_cost(seg))


def measure_latencies(
    host,
    segs: Sequence[Segment],
    oracle: LatencyOracle,
    params=None,
    *,
    stats: EngineStats | None = None,
) -> list[float]:
    """``T`` value for every segment in ``segs`` (order preserved)."""
    stats = stats if stats is not None else EngineStats()
    stats.num_latency_probes += len(segs)
    sigs = [host.probe_signature(seg) for seg in segs]
    per_bucket: dict = {}
    for seg, sig in zip(segs, sigs):
        if sig not in per_bucket:
            per_bucket[sig] = _measure(host, seg, oracle, params, stats)
    stats.num_latency_buckets += len(per_bucket)
    return [per_bucket[sig] for sig in sigs]


def layer_latencies(host, oracle: LatencyOracle, params=None) -> list[float]:
    """Per-layer latency of the untouched network (one bucketed pass)."""
    segs = [Segment(i=l - 1, j=l, k=host.original_k(l), kept=(l,),
                    original=True)
            for l in range(1, len(host.descs()) + 1)]
    return measure_latencies(host, segs, oracle, params)
