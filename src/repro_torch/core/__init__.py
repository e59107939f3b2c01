"""LayerMerge core: plans, segment enumeration, the DP, merging, latency
oracles, tables and the compression pipeline."""
from .compress import CompressResult, compress, original_latency
from .dp import DPResult, brute_force, solve_dp, solve_dp_reference, \
    solve_knapsack
from .importance import magnitude_importance
from .latency import (AnalyticOracle, CostBreakdown, WallClockOracle,
                      conv2d_cost, oracle_token)
from .plan import CompressionPlan, LayerDesc, Segment, identity_plan
from .probe_engine import (EngineStats, ProbeCallable, layer_latencies,
                           measure_latencies)
from .segments import (SegmentEnumerator, pareto_prune_options,
                       subset_selection, table_entry_count)
from .tables import Tables, build_tables, enumerate_probes, one_segment_plan

__all__ = [
    "CompressResult", "compress", "original_latency",
    "DPResult", "brute_force", "solve_dp", "solve_dp_reference",
    "solve_knapsack", "magnitude_importance",
    "AnalyticOracle", "CostBreakdown", "WallClockOracle", "conv2d_cost",
    "oracle_token",
    "CompressionPlan", "LayerDesc", "Segment", "identity_plan",
    "EngineStats", "ProbeCallable", "layer_latencies", "measure_latencies",
    "SegmentEnumerator", "pareto_prune_options", "subset_selection",
    "table_entry_count",
    "Tables", "build_tables", "enumerate_probes", "one_segment_plan",
]
