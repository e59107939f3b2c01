"""Logical-axis sharding rules (MaxText-style) for the explicit mesh path.

The port's copy of the JAX package's ``sharding/rules.py``.  Model code
and artifacts name every dimension with a *logical* axis ('embed',
'heads', 'ffn', 'vocab', 'batch', 'kv_seq', 'conv_out', …); a
:class:`ShardingRules` maps those names to mesh axes.
:meth:`ShardingRules.spec` is the reference's ``PartitionSpec``, as a
plain tuple with one entry per dimension (a mesh axis, a tuple of axes,
or None), with the same rules: an axis is used once per spec, and with a
``shape`` a dimension its axes do not divide stays whole (the GQA
``kv < model`` fallback, or SmolLM's 9 heads on a 'model' axis of 2).

Where JAX places an array by a ``NamedSharding`` and XLA inserts the
collectives, here every rank holds plain local tensors: :meth:`named`
gives a :class:`Placement` (mesh, spec, global shape), whose
:meth:`~Placement.take` slices a whole tensor to this rank's block (the
port's ``device_put``), and which a loaded tensor carries as its
``sharding`` attribute.  The unit loops read the layouts and issue the
collectives themselves (:mod:`repro_torch.sharding.collectives`,
:mod:`repro_torch.runtime.executor`).

An ambient context (:func:`use_rules`) lets the model code ask
:func:`current_rules` without threading the mesh through every function;
outside it (or with a rules object without a mesh) every block runs its
single-device path and :func:`logical_constraint` returns its input.

Default production mapping (:func:`make_rules`): ``batch`` → the data
axes; ``embed`` → the data axes for parameters (FSDP); ``heads`` /
``ffn`` / ``vocab`` / ``experts`` / ``rank`` → 'model'; ``kv`` → 'model'
when it divides; ``kv_seq`` → 'model' for decode caches
(flash-decoding); ``conv_out`` / ``channels`` / ``act_channels`` →
'model' for merged-CNN graphs, ``conv_in`` whole.  :func:`make_unit_rules`
is the serving set (weights whole over 'data').
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Mapping

import torch


@dataclasses.dataclass
class ShardingRules:
    mesh: Any                         # HostMesh-like (reads .shape) | None
    rules: Mapping[str, Any]          # logical name -> mesh axis (or tuple)

    def spec(self, names, shape=None) -> tuple:
        """The per-dimension mesh axes of a tuple of logical names.

        ``shape`` (optional) enables the divisibility fallback: a dim
        that its mesh axes do not divide is replicated instead."""
        if self.mesh is None:
            return ()
        parts = []
        used = set()
        for i, n in enumerate(names):
            ax = self.rules.get(n) if n is not None else None
            if ax is None:
                parts.append(None)
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            axes = tuple(a for a in axes if a in self.mesh.shape
                         and a not in used)
            if not axes:
                parts.append(None)
                continue
            if shape is not None:
                size = math.prod(self.mesh.shape[a] for a in axes)
                if shape[i] % size != 0:
                    parts.append(None)
                    continue
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
        return tuple(parts)

    def named(self, names, shape=None) -> "Placement":
        return Placement(self.mesh, self.spec(tuple(names), shape),
                         None if shape is None else tuple(shape))


def _axes_of(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor's blocks lie: the port's ``NamedSharding``.

    ``spec`` has one entry per leading dimension (missing entries are
    None: whole); ``shape`` is the global shape where known.  Dimension
    ``i`` split over axes ``a`` is cut into ``mesh.axis_size(a)``
    contiguous blocks, block ``k`` on the ranks whose (row-major) index
    over ``a`` is ``k``."""

    mesh: Any
    spec: tuple
    shape: tuple | None = None

    def split_dims(self) -> list:
        return [i for i, p in enumerate(self.spec) if p is not None]

    def _block(self, i: int) -> tuple[int, int]:
        """(index, count) of this rank's block along dimension ``i``."""
        axes = _axes_of(self.spec[i] if i < len(self.spec) else None)
        idx, count = 0, 1
        for a in axes:
            idx = idx * self.mesh.shape[a] + self.mesh.index(a)
            count *= self.mesh.shape[a]
        return idx, count

    def local_shape(self, shape) -> tuple:
        out = []
        for i, n in enumerate(shape):
            _, count = self._block(i)
            if n % count:
                raise ValueError(f"dimension {i} of {tuple(shape)} does "
                                 f"not divide into {count} blocks")
            out.append(n // count)
        return tuple(out)

    def slices(self, shape) -> tuple:
        """This rank's block of a tensor of global ``shape``."""
        out = []
        for i, n in enumerate(shape):
            idx, count = self._block(i)
            size = n // count
            out.append(slice(idx * size, (idx + 1) * size))
        return tuple(out)

    def take(self, t):
        """This rank's block of the whole tensor ``t`` (a contiguous copy
        where it is a proper block, ``t`` itself where the placement is
        whole), carrying this placement as its ``sharding``."""
        if not self.split_dims():
            out = t
        else:
            out = t[self.slices(t.shape)].contiguous()
        return with_sharding(out, Placement(self.mesh, self.spec,
                                            tuple(t.shape)))

    def is_split(self, dim: int) -> bool:
        return dim < len(self.spec) and self.spec[dim] is not None


def with_sharding(t, placement):
    """``t`` carrying ``placement`` as its ``sharding`` attribute (the
    analogue of ``jax.Array.sharding``; a tensor without one is whole)."""
    if isinstance(t, torch.Tensor):
        t.sharding = placement
    return t


def sharding_of(t):
    """The placement a tensor carries, or None (whole)."""
    return getattr(t, "sharding", None)


_ctx = threading.local()


def current_rules() -> ShardingRules | None:
    return getattr(_ctx, "rules", None)


def active_rules() -> ShardingRules | None:
    """The ambient rules when they have a mesh, else None."""
    r = current_rules()
    return r if r is not None and r.mesh is not None else None


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    prev = getattr(_ctx, "rules", None)
    _ctx.rules = rules
    try:
        yield rules
    finally:
        _ctx.rules = prev


def local_shape(names, shape) -> tuple[tuple, tuple]:
    """``(this rank's block shape, spec)`` of a tensor of global ``shape``
    whose dimensions are named ``names``, under the ambient rules (with
    the divisibility fallback); ``(shape, ())`` outside them."""
    r = active_rules()
    if r is None:
        return tuple(shape), ()
    place = r.named(tuple(names), tuple(shape))
    return place.local_shape(shape), place.spec


def data_axes(rules: ShardingRules) -> tuple:
    """The mesh axes the 'batch' rule maps to (the data axes), in mesh
    order, of size larger than 1."""
    names = set(_axes_of(rules.rules.get("batch")))
    return tuple(a for a in rules.mesh.axis_names
                 if a in names and rules.mesh.shape[a] > 1)


def gather_data_split(leaves: dict, lead: int = 0) -> dict:
    """FSDP: ``leaves`` (key → ``(t, placement)``: this rank's block of a
    weight and its placement, past ``lead`` leading dimensions — a layer
    of a stacked leaf) with every dimension a placement splits over the
    data axes gathered whole, one bucket per (axes, dtype) in one
    collective each way
    (:func:`repro_torch.sharding.collectives.gather_weights`, whose
    backward reduce-scatters the gradients onto the blocks).  Dimensions
    split over 'model' stay blocks: the blocks compute on them.  Returns
    key → tensor; each ``t`` as it is outside the ambient rules or
    without a placement."""
    out = {k: t for k, (t, _) in leaves.items()}
    r = active_rules()
    if r is None:
        return out
    from . import collectives as C

    daxes = set(data_axes(r))
    buckets: dict = {}
    for k, (t, place) in leaves.items():
        if place is None:
            continue
        split = [(i, _axes_of(part)) for i, part in
                 enumerate(place.spec[lead:])
                 if any(a in daxes for a in _axes_of(part))]
        if not split:
            continue
        if len(split) > 1 or not set(split[0][1]) <= daxes:
            raise ValueError(f"{k}: FSDP gathers one dimension split over "
                             f"data axes only, not {place.spec}")
        dim, axes = split[0]
        buckets.setdefault((axes, t.dtype, place.mesh), []).append((k, dim))
    for (axes, _, mesh), items in buckets.items():
        whole = C.gather_weights([out[k] for k, _ in items],
                                 [d for _, d in items], mesh, axes)
        out.update(zip((k for k, _ in items), whole))
    return out


def logical_constraint(x, names, *, current=()):
    """Re-lay out the local tensor ``x`` from the spec ``current`` (whole
    by default) to the spec its logical ``names`` resolve to under the
    ambient rules: every dimension split in ``current`` and not in the
    target is all-gathered, every dimension split in the target and not
    in ``current`` is sliced to this rank's block.  A no-op outside
    :func:`use_rules`, as in the reference."""
    r = active_rules()
    if r is None:
        return x
    from . import collectives as C

    mesh = r.mesh
    cur = tuple(current) + (None,) * (x.ndim - len(current))
    full = [n * mesh.axis_size(_axes_of(p)) for n, p in zip(x.shape, cur)]
    target = r.spec(tuple(names), full)
    target = tuple(target) + (None,) * (x.ndim - len(target))
    for i, (c, t) in enumerate(zip(cur, target)):
        if c is not None and c != t:
            x = C.all_gather(x, mesh, _axes_of(c), dim=i)
    place = Placement(mesh, target)
    for i, (c, t) in enumerate(zip(cur, target)):
        if t is not None and c != t:
            idx, count = place._block(i)
            size = x.shape[i] // count
            x = x.narrow(i, idx * size, size)
    return x.contiguous()


# ---------------------------------------------------------------------------
# Rule presets
# ---------------------------------------------------------------------------

def make_rules(mesh, *, fsdp: bool = True, seq_parallel: bool = False,
               decode_kv_model: bool = True,
               opt_state: bool = False) -> ShardingRules:
    """The production mapping (the reference's, name for name)."""
    data_axes = tuple(a for a in ("pod", "data") if mesh is not None
                      and a in mesh.shape) or ("data",)
    rules = {
        # activations
        "batch": data_axes,
        "seq": (data_axes if seq_parallel else None),
        "act_embed": None,
        "act_heads": "model",
        "act_ffn": "model",
        "act_vocab": "model",
        # parameters (FSDP shards the embed dim over the data axes)
        "embed": (data_axes if fsdp else None),
        "heads": "model",
        "kv": "model",
        "head": None,
        "ffn": "model",
        "ffn_in": None,
        "vocab": "model",
        "experts": "model",
        # expert weights: TP-sharded and data-replicated; their ZeRO-1
        # optimizer moments data-sharded (the opt_state=True rule set)
        "expert_embed": (data_axes if opt_state else None),
        "expert_ffn": None,
        "moe_group": data_axes,
        "rank": "model",
        "layers": None,
        # decode KV cache: sequence over the model axis (flash-decoding)
        "kv_seq": ("model" if decode_kv_model else None),
        # merged-CNN unit graphs: channels are the model axis
        "conv_in": None,
        "conv_out": "model",
        "channels": "model",
        "act_channels": "model",
    }
    return ShardingRules(mesh=mesh, rules=rules)


def make_unit_rules(mesh, *, decode_kv_model: bool = True) -> ShardingRules:
    """The serving rule set for unit-graph artifacts: :func:`make_rules`
    with weights whole over 'data' (``fsdp=False``): the batch on 'data',
    'ffn' / 'heads' / 'vocab' / 'conv_out' / 'rank' on 'model'."""
    return make_rules(mesh, fsdp=False, decode_kv_model=decode_kv_model)


def _is_names(x) -> bool:
    return isinstance(x, tuple) or x is None


def _tree_map(fn, tree, *rest):
    if _is_names(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    raise TypeError(f"not an axes tree leaf: {tree!r}")


def param_shardings(rules: ShardingRules, axes_tree):
    """A tree of logical-axes tuples (None: whole) → :class:`Placement`s."""
    return _tree_map(lambda ax: Placement(
        rules.mesh, () if ax is None else rules.spec(tuple(ax))), axes_tree)


def param_shardings_with_shapes(rules: ShardingRules, axes_tree,
                                shape_tree):
    """Like :func:`param_shardings`, with the divisibility fallback per
    leaf (``shape_tree``'s leaves: tensors or shapes)."""
    def one(ax, shaped):
        shape = tuple(shaped.shape) if hasattr(shaped, "shape") \
            else tuple(shaped)
        if ax is None:
            return Placement(rules.mesh, (), shape)
        return Placement(rules.mesh, rules.spec(tuple(ax), shape), shape)
    return _tree_map(one, axes_tree, shape_tree)


def put(tree, placements):
    """The port's ``jax.device_put(tree, shardings)``: every whole tensor
    of ``tree`` sliced to this rank's block of its placement (each block
    carries its ``sharding``); a tensor that already carries one (a block
    ``load(path, rules=)`` placed) and non-tensor leaves are kept."""
    if isinstance(placements, Placement):
        if not isinstance(tree, torch.Tensor) or sharding_of(tree) is not None:
            return tree
        return placements.take(tree)
    if isinstance(tree, dict):
        return {k: put(v, placements[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [put(v, p) for v, p in zip(tree, placements)]
    return tree
