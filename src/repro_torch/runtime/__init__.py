"""Plan execution: the unit IR (:mod:`.ir`), the executor (:mod:`.executor`)
and merged-model artifacts in the JAX package's ``.npz`` format
(:mod:`.artifact`)."""
from .artifact import (ArtifactError, CompressedArtifact, fingerprint, load,
                       save)
from .executor import GraphModule, execute
from .ir import (AttnUnit, ConvUnit, PoolUnit, UnitGraph, UpsampleUnit,
                 annotate_axes, bind_params, count_units, graph_params)

__all__ = [
    "ArtifactError", "CompressedArtifact", "fingerprint", "load", "save",
    "GraphModule", "execute",
    "AttnUnit", "ConvUnit", "PoolUnit", "UnitGraph", "UpsampleUnit",
    "annotate_axes", "bind_params", "count_units", "graph_params",
]
