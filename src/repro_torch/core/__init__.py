"""LayerMerge core: plans, segment enumeration, the DP, merging, latency
oracles, tables (with their cache and build journal) and the compression
pipeline, and the distributed table build."""
from . import table_cache
from .compress import CompressResult, compress, original_latency
from .dist_build import (DistBuildError, DistReport, WorkItem,
                         dist_build_tables, latency_work_items)
from .dp import DPResult, brute_force, solve_dp, solve_dp_reference, \
    solve_knapsack
from .importance import (ImportanceSpec, accuracy_perf,
                         adam_finetune_batched, distill_loss,
                         magnitude_importance, measure_importance,
                         neg_loss_perf, perf_to_importance, xent_loss)
from .latency import (AnalyticOracle, CostBreakdown, WallClockOracle,
                      conv2d_cost, oracle_token)
from .plan import CompressionPlan, LayerDesc, Segment, identity_plan
from .probe_engine import (ENGINES, PROBE_MEASURED, PROBE_QUARANTINED,
                           PROBE_RETIMED, EngineStats, ProbeCallable,
                           ProbeConfig, ProbeTimeout, layer_latencies,
                           measure_importances, measure_latencies,
                           probe_segment)
from .segments import (SegmentEnumerator, pareto_prune_options,
                       subset_selection, table_entry_count)
from .tables import Tables, build_tables, enumerate_probes, one_segment_plan

__all__ = [
    "table_cache",
    "CompressResult", "compress", "original_latency",
    "DistBuildError", "DistReport", "WorkItem", "dist_build_tables",
    "latency_work_items",
    "DPResult", "brute_force", "solve_dp", "solve_dp_reference",
    "solve_knapsack",
    "ImportanceSpec", "accuracy_perf", "adam_finetune_batched",
    "distill_loss", "magnitude_importance", "measure_importance",
    "neg_loss_perf", "perf_to_importance", "xent_loss",
    "AnalyticOracle", "CostBreakdown", "WallClockOracle", "conv2d_cost",
    "oracle_token",
    "CompressionPlan", "LayerDesc", "Segment", "identity_plan",
    "ENGINES", "PROBE_MEASURED", "PROBE_QUARANTINED", "PROBE_RETIMED",
    "EngineStats", "ProbeCallable", "ProbeConfig", "ProbeTimeout",
    "layer_latencies", "measure_importances", "measure_latencies",
    "probe_segment",
    "SegmentEnumerator", "pareto_prune_options", "subset_selection",
    "table_entry_count",
    "Tables", "build_tables", "enumerate_probes", "one_segment_plan",
]
