"""Unit IR for merged (compressed) networks — the JAX package's record format.

A :class:`UnitGraph` is the executable form of a compression plan: an
ordered chain of typed *units*, each a record of STATIC configuration
(strides, activation epilogue, skip wiring) plus a ``params`` tree of
tensors (merged weights).  The hosts' ``lower_plan`` builds it, the
executor (:mod:`.executor`) runs it and the artifact layer
(:mod:`.artifact`) serializes it.  Field names, defaults and the ``axes``
records are the JAX package's, so unit statics and artifacts cross between
the two packages unchanged (the statics and axes enter the fingerprint).

CNN unit semantics: conv → skip-add → concat → group-norm → boundary
activation → save.  Transformer units: ``lowrank`` (a merged rank-r
residual map) and ``sublayer`` (one kept pre-norm block).
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


@dataclasses.dataclass
class LowRankUnit:
    """Rank-``r`` residual map ``x + (x·U)·V`` — a merged FFN segment.

    ``params``: ``u`` (D,r), ``v`` (r,D); runs through ``merged_ffn_op``.
    ``quant`` != 'none': ``u``/``v`` narrow plus per-output-channel
    ``u_scale`` (r,) and ``v_scale`` (D,).
    """

    kind = "lowrank"
    quant: str = "none"             # 'none' | 'int8' | 'w8a8' | 'fp8'
    axes: dict = dataclasses.field(default_factory=dict)
    params: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SublayerUnit:
    """One kept transformer sublayer: pre-norm → block → residual add.

    ``sub_kind``: 'attn' | 'attn_local' | 'ffn' | 'moe' | 'rglru' |
    'mlstm' | 'slstm'.  ``params``: {'norm': rmsnorm scale, 'p': the
    block's params}.  Temporal kinds carry decode state: a KV cache
    (attention), the recurrent state ``{h, conv}`` (RG-LRU), ``{C, n,
    m}`` (mLSTM) or ``{c, n, m}`` (sLSTM).
    """

    kind = "sublayer"
    sub_kind: str = "ffn"
    axes: dict = dataclasses.field(default_factory=dict)
    params: dict = dataclasses.field(default_factory=dict)


UNIT_TYPES = {
    "conv": ConvUnit,
    "pool": PoolUnit,
    "upsample": UpsampleUnit,
    "attn": AttnUnit,
    "lowrank": LowRankUnit,
    "sublayer": SublayerUnit,
}

#: temporal sublayer kinds that carry decode state in the serve path
TEMPORAL_KINDS = ("attn", "attn_local", "rglru", "mlstm", "slstm")


@dataclasses.dataclass
class UnitGraph:
    """Executable form of a plan: ordered units + graph-level params.

    ``family``: 'cnn' | 'transformer'.  ``params``: cnn — optional
    ``head`` {w, b}; transformer — ``final_norm``, optional ``embed`` and
    ``unembed``.  ``meta``: cnn — ``save_input`` (boundary 0 feeds a skip)
    and ``head`` ('classifier' | 'none'); transformer — ``config`` (the
    :class:`~repro_torch.configs.ArchConfig`, a plain dict in the artifact
    spec).  ``axes``: logical axes of the graph-level params.
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
    """Unit census: kind → count (depthwise convs counted as 'dwconv',
    sublayers as 'sublayer:<sub_kind>')."""
    out: dict[str, int] = {}
    for u in graph.units:
        key = u.kind
        if u.kind == "conv" and u.depthwise:
            key = "dwconv"
        elif u.kind == "sublayer":
            key = f"sublayer:{u.sub_kind}"
        out[key] = out.get(key, 0) + 1
    return out


# Logical-axis annotations: flat {param keypath → [logical names]} records,
# the JAX package's artifact sharding contract.  The keypath joins keys
# with '/' as the artifact's array layout does; a name of None (JSON null)
# means "never split".  Keypaths absent from a record resolve to whole, so
# partial annotations (and the empty record of a v1 artifact) are valid.

def axes_tree(params, flat_axes, prefix: str = ""):
    """Axes tree aligned leaf for leaf with ``params``: each tensor leaf
    becomes the tuple of logical names recorded for its '/'-joined
    keypath, or None (whole) — the tree that
    :func:`repro_torch.sharding.rules.param_shardings_with_shapes` takes."""
    if isinstance(params, dict):
        return {k: axes_tree(v, flat_axes, f"{prefix}{k}/")
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [axes_tree(v, flat_axes, f"{prefix}{i}/")
                for i, v in enumerate(params)]
    names = flat_axes.get(prefix[:-1])
    return tuple(names) if names else None


def unit_axes(unit):
    """Logical-axes tree matching ``unit.params``."""
    return axes_tree(unit.params, unit.axes)


def graph_axes(graph: UnitGraph) -> dict:
    """Logical-axes tree matching :func:`graph_params`."""
    return {"units": [unit_axes(u) for u in graph.units],
            "globals": axes_tree(graph.params, graph.axes)}
_CONV_W = [None, None, "conv_in", "conv_out"]
_CONV_W_DW = [None, None, None, "conv_out"]        # (K,K,1,C) depthwise


def _flat_names(tree, prefix: str = "") -> dict:
    """Flatten a nested {key: names-tuple} tree to the flat-dict form."""
    out: dict = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_names(v, f"{prefix}{k}/"))
        elif v:
            out[f"{prefix}{k}"] = list(v)
    return out


def _sublayer_axes(u, cfg) -> dict:
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    if u.sub_kind == "ffn":
        block = L.ffn_axes(cfg.ffn_kind)
    elif u.sub_kind == "moe":
        block = MOE.moe_axes()
    elif u.sub_kind in TEMPORAL_KINDS:
        block = T.temporal_axes(cfg, u.sub_kind)
    else:
        raise ValueError(f"unknown sublayer kind {u.sub_kind!r}")
    ax = {"norm": ["embed"]}
    ax.update(_flat_names({"p": block}))
    return ax


def default_unit_axes(unit, cfg=None) -> dict:
    """The canonical logical-axes record of one unit; ``cfg`` (the
    transformer config) is needed for sublayer units only."""
    if unit.kind == "lowrank":
        ax = {"u": ["embed", "rank"], "v": ["rank", "embed"]}
        if "u_scale" in unit.params:
            ax["u_scale"] = ["rank"]
        if "v_scale" in unit.params:
            ax["v_scale"] = ["embed"]
        return ax
    if unit.kind == "sublayer":
        return _sublayer_axes(unit, cfg)
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
    out: dict = {}
    if graph.family == "transformer":
        if "embed" in graph.params:
            out["embed"] = ["vocab", "embed"]
        out["final_norm"] = ["embed"]
        if "unembed" in graph.params:
            out["unembed"] = ["embed", "vocab"]
    elif "head" in graph.params:
        out["head/w"] = ["conv_in", "vocab"]
        out["head/b"] = ["vocab"]
    return out


def annotate_axes(graph: UnitGraph) -> UnitGraph:
    """Fill in the canonical axes records on a freshly lowered graph
    (records already present, e.g. from an artifact, are kept)."""
    cfg = graph.meta.get("config")
    for u in graph.units:
        if not u.axes:
            u.axes = default_unit_axes(u, cfg)
    if not graph.axes:
        graph.axes = graph_global_axes(graph)
    return graph
