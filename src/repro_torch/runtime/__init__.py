"""Plan execution: the unit IR (:mod:`.ir`), the executor (:mod:`.executor`),
merged-model artifacts in the JAX package's ``.npz`` format
(:mod:`.artifact`) and greedy KV-cache serving (:mod:`.serving`)."""
from .artifact import (ArtifactError, CompressedArtifact, fingerprint, load,
                       save)
from .executor import GraphModule, decode_step, execute, init_cache, \
    run_units
from .ir import (AttnUnit, ConvUnit, LowRankUnit, PoolUnit, SublayerUnit,
                 UnitGraph, UpsampleUnit, annotate_axes, bind_params,
                 count_units, graph_params)

__all__ = [
    "ArtifactError", "CompressedArtifact", "fingerprint", "load", "save",
    "GraphModule", "decode_step", "execute", "init_cache", "run_units",
    "AttnUnit", "ConvUnit", "LowRankUnit", "PoolUnit", "SublayerUnit",
    "UnitGraph", "UpsampleUnit",
    "annotate_axes", "bind_params", "count_units", "graph_params",
]
