"""Algorithm 2 — the LayerMerge procedure, plus the two baselines.

``compress(host, ...)`` runs: build tables → DP (Algorithm 1) → plan.
``method``:

* ``'layermerge'`` — the paper's joint optimization (activations + layers);
* ``'depth'``      — Kim et al. 2023 baseline: activations only (C = [L]);
* ``'layeronly'``  — whole-layer knapsack (Problem 8), no merging.

Results are artifact-backed: ``CompressResult.save(path)`` lowers the plan
through ``host.lower_plan`` and publishes a merged-model artifact in the
JAX package's ``.npz`` format (:mod:`repro_torch.runtime.artifact`).
"""
from __future__ import annotations

import dataclasses
import math
import time

from . import probe_engine
from .dp import solve_dp, solve_knapsack
from .latency import AnalyticOracle, LatencyOracle, WallClockOracle, \
    oracle_token
from .plan import CompressionPlan, Segment
from .tables import Tables, build_tables


@dataclasses.dataclass
class CompressResult:
    plan: CompressionPlan
    tables: Tables | None
    original_latency: float
    compressed_latency: float
    dp_seconds: float
    oracle: LatencyOracle | None = None   # the resolved latency oracle
    host: object = None                   # the host that planned
    params: object = None                 # params the plan was built against

    @property
    def speedup(self) -> float:
        return self.original_latency / max(self.compressed_latency, 1e-12)

    def lower(self):
        """Lower the plan to the unit IR (merged, deployable form)."""
        return self.host.lower_plan(self.plan, self.params)

    def save(self, path: str, extra_meta: dict | None = None) -> str:
        """Publish the merged-model artifact; returns its fingerprint."""
        from repro_torch import runtime
        from repro_torch.device import device_name

        meta = {
            "oracle": (oracle_token(self.oracle)
                       if self.oracle is not None else None),
            "original_latency": self.original_latency,
            "compressed_latency": self.compressed_latency,
            "predicted_speedup": self.speedup,
            "method": self.plan.method,
            "quantized_units": sum(1 for s in self.plan.segments
                                   if s.quant != "none"),
            "probe_provenance": [],
        }
        if isinstance(self.oracle, WallClockOracle):
            meta["timed_on"] = device_name(self.host.device)
        meta.update(extra_meta or {})
        return runtime.save(path, self.lower(), plan=self.plan, meta=meta)


def original_latency(host, latency_oracle=None, params=None) -> float:
    """Σ per-layer latency of the untouched network (the paper's T_orig)."""
    oracle = latency_oracle or AnalyticOracle()
    return sum(probe_engine.layer_latencies(host, oracle, params))


def compress(
    host,
    *,
    budget_ratio: float,
    P: int = 200,
    method: str = "layermerge",
    latency_oracle: LatencyOracle | None = None,
    params=None,
) -> CompressResult | None:
    """Run LayerMerge (or a baseline) at ``T0 = budget_ratio · T_orig``
    with magnitude importance; ``None`` when no plan fits the budget."""
    oracle = latency_oracle or AnalyticOracle()
    layer_lats = probe_engine.layer_latencies(host, oracle, params)
    t_orig = sum(layer_lats)
    T0 = budget_ratio * t_orig
    L = len(host.descs())

    if method == "layeronly":
        return _layer_only(host, T0, P, oracle, params, t_orig, layer_lats)

    tables = build_tables(host, method=method, latency_oracle=oracle,
                          params=params)
    t0 = time.perf_counter()
    res = solve_dp(L, tables.fn(), T0, P, method=method,
                   original_k=host.original_k)
    dp_s = time.perf_counter() - t0
    if res is None:
        return None
    return CompressResult(plan=res.plan, tables=tables,
                          original_latency=t_orig,
                          compressed_latency=res.latency,
                          dp_seconds=dp_s, oracle=oracle, host=host,
                          params=params)


def _layer_only(host, T0, P, oracle, params, t_orig, layer_lats):
    """Problem 8: latency-aware layer pruning (knapsack), magnitude
    importance of keeping each layer."""
    descs = host.descs()
    L = len(descs)
    lat = dict(zip(range(1, L + 1), layer_lats))
    forced = tuple(d.index for d in descs if not d.prunable)
    total = sum(d.value for d in descs) or 1.0
    imp = {l: 1.0 if not descs[l - 1].prunable
           else math.exp(descs[l - 1].value / total)
           for l in range(1, L + 1)}
    t0 = time.perf_counter()
    sol = solve_knapsack(L, imp, lat, T0, P, forced=forced)
    dp_s = time.perf_counter() - t0
    if sol is None:
        return None
    C, obj, true_lat = sol
    kept = set(C)
    segs = tuple(
        Segment(i=l - 1, j=l,
                k=host.original_k(l) if l in kept else host.pruned_k(l),
                kept=(l,) if l in kept else (),
                original=l in kept)
        for l in range(1, L + 1))
    plan = CompressionPlan(num_layers=L, segments=segs, objective=obj,
                           latency=true_lat, budget=T0, method="layeronly")
    return CompressResult(plan=plan, tables=None, original_latency=t_orig,
                          compressed_latency=true_lat, dp_seconds=dp_s,
                          oracle=oracle, host=host, params=params)
