"""Unit IR for merged (compressed) CNNs — the JAX package's record format.

A :class:`UnitGraph` is the executable form of a compression plan: an
ordered chain of typed *units*, each a record of STATIC configuration
(strides, activation epilogue, skip wiring) plus a ``params`` tree of
tensors (merged weights).  ``CNNHost.lower_plan`` builds it, the executor
(:mod:`.executor`) runs it and the artifact layer (:mod:`.artifact`)
serializes it.  Field names, defaults and the ``axes`` records are the JAX
package's, so unit statics and artifacts cross between the two packages
unchanged.  Only the CNN family is ported; the transformer units
(``lowrank``, ``sublayer``) are ROADMAP queue 1.

CNN unit semantics: conv → skip-add → concat → group-norm → boundary
activation → save.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ConvUnit:
    """One merged conv segment: VALID conv at the merged kernel size.

    ``params``: ``w`` (K,K,Cin|1,Cout), ``b`` (Cout,), optional ``gn``
    {gamma, beta}, optional ``proj`` {w, b} (1×1 projection shortcut of a
    skip-add ending here) and, for ``quant`` != 'none', the per-output-
    channel ``w_scale`` of narrow weights.
    """

    kind = "conv"
    stride: int = 1
    depthwise: bool = False
    act: str = "none"               # boundary activation σ_j ('none' at σ_L)
    gn_groups: int = 8
    proj_stride: int = 1
    add_from: int | None = None     # skip-add source boundary id
    concat_from: int | None = None  # U-Net concat source boundary id
    save_at: int | None = None      # boundary id to save the output under
    quant: str = "none"             # 'none' | 'int8' | 'w8a8' | 'fp8'
    axes: dict = dataclasses.field(default_factory=dict)
    params: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PoolUnit:
    """Average-pool barrier unit (parameter-free)."""

    kind = "pool"
    k: int = 2
    stride: int = 2
    concat_from: int | None = None
    save_at: int | None = None
    axes: dict = dataclasses.field(default_factory=dict)
    params: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class UpsampleUnit:
    """Nearest-neighbour upsample barrier unit (parameter-free)."""

    kind = "upsample"
    factor: int = 2
    concat_from: int | None = None
    save_at: int | None = None
    axes: dict = dataclasses.field(default_factory=dict)
    params: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AttnUnit:
    """Single-head spatial self-attention barrier (DDPM middle block);
    ``params``: ``wq``, ``wk``, ``wv``, ``wo``, passed through unmerged."""

    kind = "attn"
    save_at: int | None = None
    axes: dict = dataclasses.field(default_factory=dict)
    params: dict = dataclasses.field(default_factory=dict)


UNIT_TYPES = {
    "conv": ConvUnit,
    "pool": PoolUnit,
    "upsample": UpsampleUnit,
    "attn": AttnUnit,
}


@dataclasses.dataclass
class UnitGraph:
    """Executable form of a plan: ordered units + graph-level params.

    ``family`` is 'cnn'.  ``params``: optional ``head`` {w, b}.  ``meta``:
    ``save_input`` (boundary 0 feeds a skip) and ``head`` ('classifier' |
    'none').  ``axes``: logical axes of the graph-level params.
    """

    family: str
    units: tuple
    params: dict = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)
    axes: dict = dataclasses.field(default_factory=dict)


def unit_static(unit) -> dict:
    """JSON-able static record of one unit (everything but ``params``)."""
    out = {"kind": unit.kind}
    for f in dataclasses.fields(unit):
        if f.name != "params":
            out[f.name] = getattr(unit, f.name)
    return out


def unit_from_static(static: dict, params: dict):
    if static["kind"] not in UNIT_TYPES:
        raise NotImplementedError(
            f"unit kind {static['kind']!r} is not ported (only the CNN "
            "family is; see ROADMAP queue 1)")
    cls = UNIT_TYPES[static["kind"]]
    kwargs = {k: v for k, v in static.items() if k != "kind"}
    return cls(params=params, **kwargs)


def graph_params(graph: UnitGraph) -> dict:
    """The graph's tensors as one tree: {'units': [...], 'globals': {...}}."""
    return {"units": [u.params for u in graph.units],
            "globals": graph.params}


def bind_params(graph: UnitGraph, params: dict) -> UnitGraph:
    """A structurally identical graph with its tensors replaced."""
    units = tuple(dataclasses.replace(u, params=p)
                  for u, p in zip(graph.units, params["units"]))
    return UnitGraph(family=graph.family, units=units,
                     params=params["globals"], meta=graph.meta,
                     axes=graph.axes)


def count_units(graph: UnitGraph) -> dict[str, int]:
    """Unit census: kind → count (depthwise convs counted as 'dwconv')."""
    out: dict[str, int] = {}
    for u in graph.units:
        key = "dwconv" if u.kind == "conv" and u.depthwise else u.kind
        out[key] = out.get(key, 0) + 1
    return out


# Logical-axis annotations: flat {param keypath → [logical names]} records,
# the JAX package's artifact sharding contract (the port does not shard
# yet, but writes the same records so artifacts stay identical).
_CONV_W = [None, None, "conv_in", "conv_out"]
_CONV_W_DW = [None, None, None, "conv_out"]        # (K,K,1,C) depthwise


def default_unit_axes(unit) -> dict:
    if unit.kind == "conv":
        ax = {"w": list(_CONV_W_DW if unit.depthwise else _CONV_W),
              "b": ["conv_out"]}
        if "w_scale" in unit.params:
            ax["w_scale"] = ["conv_out"]
        if "gn" in unit.params:
            ax["gn/gamma"] = ["conv_out"]
            ax["gn/beta"] = ["conv_out"]
        if "proj" in unit.params:
            ax["proj/w"] = list(_CONV_W)
            ax["proj/b"] = ["conv_out"]
        return ax
    if unit.kind == "attn":
        return {k: ["conv_in", "conv_out"] for k in ("wq", "wk", "wv", "wo")
                if k in unit.params}
    return {}


def graph_global_axes(graph: UnitGraph) -> dict:
    if "head" in graph.params:
        return {"head/w": ["conv_in", "vocab"], "head/b": ["vocab"]}
    return {}


def annotate_axes(graph: UnitGraph) -> UnitGraph:
    """Fill in the canonical axes records on a freshly lowered graph
    (records already present, e.g. from an artifact, are kept)."""
    for u in graph.units:
        if not u.axes:
            u.axes = default_unit_axes(u)
    if not graph.axes:
        graph.axes = graph_global_axes(graph)
    return graph
