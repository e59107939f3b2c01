"""The probe engine: ``T[i,j,k]`` latency probes bucketed by shape
signature, and ``I[i,j,k]`` Eq. 4 fine-tunes in vmapped span batches.

Latency depends on a merged segment's shapes only — never on its weight
values — so every probe is bucketed by ``host.probe_signature(seg)`` and
one representative per bucket is measured; the value is attributed to
every entry of the bucket.  Under the wall-clock oracle that is one
warmup + timing loop per distinct signature on the card, once per oracle
(:meth:`~.latency.WallClockOracle.time_signature`), under either engine.

Importance (:func:`measure_importances`): hosts that implement
``importance_batch`` hand the engine one shared ``apply_fn`` plus stacked
candidate params for a span's probes, and the few-step Adam fine-tune
runs vmapped over the probe axis
(:func:`~.importance.adam_finetune_batched`); everything else runs one
scalar fine-tune per probe.  The JAX package's journal, retries and
compile-overlap thread are not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
from torch.utils import _pytree as pytree

from .importance import (adam_finetune_batched, measure_importance,
                         perf_to_importance)
from .latency import LatencyOracle, WallClockOracle
from .plan import Segment

ENGINES = ("batched", "sequential")


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
    num_importance_probes: int = 0
    num_importance_batches: int = 0      # vmapped span batches run
    num_importance_sequential: int = 0   # scalar fine-tunes run


def _measure(host, seg: Segment, sig, oracle: LatencyOracle, params,
             stats: EngineStats) -> float:
    if isinstance(oracle, WallClockOracle):
        timed = len(oracle.measured)
        sec = oracle.time_signature(
            sig, lambda: host.segment_probe(seg, params))
        stats.num_timings += len(oracle.measured) - timed
        return sec
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
            per_bucket[sig] = _measure(host, seg, sig, oracle, params,
                                       stats)
    stats.num_latency_buckets += len(per_bucket)
    return [per_bucket[sig] for sig in sigs]


def layer_latencies(host, oracle: LatencyOracle, params=None) -> list[float]:
    """Per-layer latency of the untouched network (one bucketed pass)."""
    segs = [Segment(i=l - 1, j=l, k=host.original_k(l), kept=(l,),
                    original=True)
            for l in range(1, len(host.descs()) + 1)]
    return measure_latencies(host, segs, oracle, params)


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

    The JAX package's ``journal=`` (durable per-probe records and resume)
    waits for the table cache and journal (ROADMAP queue 1, item 3).
    """
    from .tables import one_segment_plan   # local import: tables imports us

    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected {ENGINES}")
    stats = stats if stats is not None else EngineStats()
    stats.num_importance_probes += len(segs)
    out: list[float | None] = [None] * len(segs)

    def sequential(indices):
        for n in indices:
            seg = segs[n]
            apply_fn, p = host.replaced_apply(
                one_segment_plan(host, seg), params)
            out[n] = measure_importance(apply_fn, p, spec, base_perf)
            stats.num_importance_sequential += 1
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
        if len(indices) < 2:
            # a vmap of one lane only adds overhead over the scalar probe
            # (and the Dirac stand-ins cost real FLOPs)
            sequential(indices)
            continue
        batch = batch_fn([segs[n] for n in indices], params)
        if batch is None:
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
        if progress:
            progress(f"importance batch ({span[0]},{span[1]}]: "
                     f"{len(indices)} lanes vmapped")
    return out
