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
from .importance import ImportanceSpec, measure_importance
from .latency import AnalyticOracle, LatencyOracle, WallClockOracle, \
    oracle_token
from .plan import CompressionPlan, Segment
from .tables import Tables, build_tables, one_segment_plan


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
    dist_report: object = None            # the DistReport of a table build
    #                                       fanned out over workers

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
            # the latency entries that were not clean first measurements
            # ("retimed" / "quarantined"): empty when all were
            "probe_provenance": (
                [{"i": i, "j": j, "k": k, "flag": flag}
                 for (i, j, k), flag
                 in sorted(self.tables.provenance.items())]
                if self.tables is not None else []),
        }
        if isinstance(self.oracle, WallClockOracle):
            meta["timed_on"] = device_name(self.host.device)
        meta.update(extra_meta or {})
        return runtime.save(path, self.lower(), plan=self.plan, meta=meta)


def original_latency(host, latency_oracle=None, params=None, *,
                     engine: str = "batched") -> float:
    """Σ per-layer latency of the untouched network (the paper's T_orig)."""
    oracle = latency_oracle or AnalyticOracle()
    return sum(probe_engine.layer_latencies(host, oracle, params,
                                            engine=engine))


def compress(
    host,
    *,
    budget_ratio: float,
    P: int = 200,
    method: str = "layermerge",
    latency_oracle: LatencyOracle | None = None,
    importance: ImportanceSpec | str = "magnitude",
    base_perf: float | None = None,
    params=None,
    engine: str = "batched",
    cache_dir: str | None = None,
    probe_config: probe_engine.ProbeConfig | None = None,
    resume: bool = True,
    quantize: str | None = None,
    ratio_oracle: AnalyticOracle | None = None,
    workers: int = 0,
    host_spec: dict | None = None,
    work_dir: str | None = None,
) -> CompressResult | None:
    """Run LayerMerge (or a baseline) at ``T0 = budget_ratio · T_orig``;
    ``None`` when no plan fits the budget.

    ``importance`` is the magnitude proxy (``"magnitude"``) or the paper's
    Eq. 4 (an :class:`ImportanceSpec` scored against ``base_perf``,
    fine-tuned through ``engine``; see :func:`.tables.build_tables`).

    ``quantize`` ('int8' | 'w8a8') widens every span's candidate row with
    derived precision siblings (:func:`.tables.quant_sibling_entries`,
    their latency ratio priced by ``ratio_oracle``), so the DP chooses
    merge structure and per-unit precision under one budget; segments it
    picks quantized lower to narrow-weight units.  None / 'none' leaves
    tables, DP visit order and plans bit-identical to an fp-only run.

    ``cache_dir``, ``probe_config`` and ``resume`` go to
    :func:`.tables.build_tables`: the table cache, the probe retry,
    timeout and quarantine policy, and the resume of an interrupted build
    from its journal.  The tables are built before ``T_orig`` is priced,
    so a cache hit's or a journal's timings are what the oracle holds
    when it prices the original network: ``T_orig`` and the table
    entries read one timing of each shape.

    ``workers > 0`` fans the latency probes out over subprocess workers
    (:func:`.dist_build.dist_build_tables`: needs ``cache_dir`` and a
    ``host_spec`` naming a factory that rebuilds this host in another
    process; ``work_dir`` is the shared coordination directory, under
    ``cache_dir`` by default); the fan-out's report lands on
    ``result.dist_report``.  The merged records seed the oracle as a
    resumed journal does, so ``T_orig`` reads the workers' seconds.
    """
    if quantize and quantize != "none" and method == "layeronly":
        raise ValueError("quantize is a merged-segment feature; "
                         "method='layeronly' has no merged units")
    oracle = latency_oracle or AnalyticOracle()
    tables = dist_report = None
    if method != "layeronly" and workers > 0:
        from .dist_build import DistBuildError, dist_build_tables
        from .tables import with_quant_siblings

        if cache_dir is None:
            raise DistBuildError(
                "workers > 0 requires cache_dir (worker results merge "
                "through the build journal)")
        tables, dist_report = dist_build_tables(
            host, cache_dir=cache_dir, workers=workers, host_spec=host_spec,
            method=method, latency_oracle=oracle, importance=importance,
            base_perf=base_perf, params=params, engine=engine,
            probe_config=probe_config, resume=resume, work_dir=work_dir,
            worker_device=getattr(host, "device", "cuda"))
        # precision siblings are derived after the merge: the manifest and
        # the journal stay fp-only
        tables = with_quant_siblings(tables, host, quantize, ratio_oracle)
    elif method != "layeronly":
        tables = build_tables(host, method=method, latency_oracle=oracle,
                              importance=importance, base_perf=base_perf,
                              params=params, engine=engine,
                              cache_dir=cache_dir, probe_config=probe_config,
                              resume=resume, quantize=quantize,
                              ratio_oracle=ratio_oracle)
    layer_lats = probe_engine.layer_latencies(host, oracle, params,
                                              engine=engine,
                                              probe_config=probe_config)
    t_orig = sum(layer_lats)
    T0 = budget_ratio * t_orig
    L = len(host.descs())

    if method == "layeronly":
        return _layer_only(host, T0, P, oracle, importance, base_perf,
                           params, t_orig, layer_lats)

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
                          params=params, dist_report=dist_report)


def _layer_only(host, T0, P, oracle, importance, base_perf, params, t_orig,
                layer_lats):
    """Problem 8: latency-aware layer pruning (knapsack).  ``I[l]`` is the
    importance of keeping l: ``1 / exp(ΔPerf of removing l)`` under Eq. 4,
    ``exp`` of l's ℓ1 share under the magnitude proxy."""
    descs = host.descs()
    L = len(descs)
    lat = dict(zip(range(1, L + 1), layer_lats))
    forced = tuple(d.index for d in descs if not d.prunable)
    total = sum(d.value for d in descs) or 1.0
    imp: dict[int, float] = {}
    for l in range(1, L + 1):
        if not descs[l - 1].prunable:
            imp[l] = 1.0
        elif isinstance(importance, ImportanceSpec):
            probe = Segment(i=l - 1, j=l, k=host.pruned_k(l), kept=())
            apply_fn, p = host.replaced_apply(
                one_segment_plan(host, probe), params)
            removed = measure_importance(apply_fn, p, importance,
                                         base_perf or 0.0)
            imp[l] = 1.0 / max(removed, 1e-12)
        else:
            imp[l] = math.exp(descs[l - 1].value / total)
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
