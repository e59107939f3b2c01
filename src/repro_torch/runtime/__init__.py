"""Plan execution: the unit IR (:mod:`.ir`), the executor (:mod:`.executor`,
with the mesh-aware :class:`GraphExecutor`), merged-model artifacts in the
JAX package's ``.npz`` format (:mod:`.artifact`, ``load(path, rules=)``)
and greedy KV-cache serving (:mod:`.serving`)."""
from .artifact import (ArtifactError, CompressedArtifact, fingerprint, load,
                       save)
from .executor import (GraphExecutor, GraphModule, cache_axes,
                       cache_shardings, decode_step, execute,
                       graph_shardings, init_cache, jit_apply,
                       make_serve_step, run_units, slot_state)
from .ir import (AttnUnit, ConvUnit, LowRankUnit, PoolUnit, SublayerUnit,
                 UnitGraph, UpsampleUnit, annotate_axes, axes_tree,
                 bind_params, count_units, graph_axes, graph_params,
                 unit_axes)

__all__ = [
    "ArtifactError", "CompressedArtifact", "fingerprint", "load", "save",
    "GraphExecutor", "GraphModule", "cache_axes", "cache_shardings",
    "decode_step", "execute", "graph_shardings", "init_cache", "jit_apply",
    "make_serve_step", "run_units", "slot_state",
    "AttnUnit", "ConvUnit", "LowRankUnit", "PoolUnit", "SublayerUnit",
    "UnitGraph", "UpsampleUnit",
    "annotate_axes", "axes_tree", "bind_params", "count_units", "graph_axes",
    "graph_params", "unit_axes",
]
