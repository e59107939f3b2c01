"""UnitGraph interpreter for merged CNNs and transformers.

Every conv and lowrank unit runs through the public kernel entry points
(:mod:`repro_torch.kernels`): the hand-written CUDA kernels on the card,
their plain PyTorch versions on the CPU — so serving exercises exactly the
kernels the latency tables timed.  The CNN epilogue order is the JAX
package's (``runtime/executor.py``): the kernel is called without an
activation, then skip-add (through the 1×1 projection when the unit has
one), concat, group norm, and the boundary activation.

* :func:`execute` — full forward: an NHWC image batch (cnn) or a token
  batch ``{"tokens": (B, S)}`` (transformer prefill).
* :func:`run_units` — a bare transformer unit chain, no embed/unembed
  (the segment probes).
* :func:`execute_local` — a transformer prefill as a rank takes its loss:
  its rows' logits, its vocab slice.
* :func:`init_cache` / :func:`decode_step` — one-token decode through a
  compressed transformer: a KV cache per attention sublayer, the
  recurrent state per RG-LRU, mLSTM or sLSTM sublayer; lowrank, FFN and
  MoE units carry no state.  A batch may carry M-RoPE's
  ``mrope_positions`` (3, B, S) beside ``tokens`` or ``embeds``.
  :func:`slot_state` is the continuous engine's per-slot state.
* :class:`GraphModule` — an ``nn.Module`` holding a graph's tensors as
  buffers (so ``.to(device)`` moves them), whose ``forward`` is
  :func:`execute`.
* :func:`jit_apply` / :func:`make_serve_step` — ``fn(params, inputs)``
  and ``step(params, cache, batch)`` over a graph, with its tensors as
  one tree (the JAX package's jitted forms, plain callables here).
* :class:`GraphExecutor` — the mesh-aware serving entry point: the
  graph's logical axes (:func:`repro_torch.runtime.ir.graph_axes`)
  resolved through a :class:`~repro_torch.sharding.rules.ShardingRules`
  (:func:`graph_shardings`, :func:`cache_shardings`), each rank holding
  its blocks, prefill and decode run under the rules.  ``rules=None`` is
  exactly the single-device path.

Under a mesh (the ambient rules of
:func:`repro_torch.sharding.rules.use_rules`) the same loops run on each
rank's shards, Megatron-style: every kernel op runs on local tensors and
a unit calls a collective only where its arithmetic needs one
(:mod:`repro_torch.sharding.collectives`); XLA's GSPMD inserts them for
the JAX package.  The batch is split over the data axes where they
divide it, and the outputs are gathered back, so the caller sees the
single-device shapes.  What each family does, and where it is delicate:

* CNN: each conv's output channels ('conv_out') are split over 'model',
  'conv_in' whole, so a dense conv all-gathers its input channels, while
  the per-channel work (a depthwise conv, bias, activation, pool,
  upsample, the residual add) runs on the rank's channels with no
  gather.  A projection shortcut follows 'conv_out'.  GroupNorm runs on
  the local channels only where 'model' divides its group count, else
  it gathers them (and its scale and shift).  The concat with a saved
  tensor, the DDPM middle block's self-attention (its scores summed over
  'model', its values gathered) and the classifier head (channel means
  gathered, the class slices gathered) gather.
* w8a8: the activation's scale is per tensor.  A rank that quantized its
  block of the batch or of the channels from its own ``amax`` would get
  other codes than one device does, so the ``amax`` is reduced
  (``all_reduce(MAX)``) over every axis the activation is split on
  before the division (``reduce_amax`` of the ops).  The activations
  themselves must be bitwise the single device's too: ``merged_conv``
  splits its reduction by a plan that depends on the batch and Cout, so
  a dense conv on a rank's block is launched with the whole product's
  plan (``plan_as``), summing each output in the single device's order.
  Then every rank's codes are bitwise the single device's block.
* Lowrank units: ``merged_ffn`` fuses the residual, ``x + (x̂·U)·V``, and
  with 'rank' on 'model' each rank holds ``U[:, r]`` and ``V[r, :]``: the
  sum of the ranks' outputs would add ``x`` once a rank.  Rank 0 of
  'model' keeps the residual, the others run the kernel with
  ``residual=False``, and the outputs are all-reduced.  For training,
  ``x`` enters the split product through ``enter_split`` (its gradient
  summed over 'model', the residual's identity from rank 0 alone) and
  the all-reduce passes its gradient through; weights FSDP split over
  the data axes are gathered whole per unit (``gather_weights``, their
  gradients reduce-scattered back), so
  :func:`repro_torch.train.step.make_compressed_forward` trains sharded
  (:func:`execute_local` gives each rank's share of the loss).
* Sublayers: each block returns its rank's partial where its output
  projection contracts a split dimension; the unit all-reduces it
  (:func:`repro_torch.models.transformer.reduce_partial`) before the
  residual add.  The embedding is a masked gather of the rank's vocab
  slice and an all-reduce, the logits an all-gather of the slices
  (RecurrentGemma ties the two to one table).  The decode cache follows
  'kv_seq' (:mod:`repro_torch.models.layers`: flash-decoding, a
  branch-free write).  MoE and xLSTM sublayers run under a data-only
  mesh and raise under a 'model' axis larger than 1.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch import kernels
from repro_torch.device import resolve
from repro_torch.models import cnn as _cnn
from repro_torch.models import layers as L
from repro_torch.models import rglru as RG
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as XL
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import (active_rules,
                                        param_shardings_with_shapes, put,
                                        sharding_of, use_rules)

from . import ir
from repro_torch.tree import flatten_tree, unflatten_tree


def execute(graph: ir.UnitGraph, inputs, params=None, *, device="cuda"):
    """Run a UnitGraph on ``device`` (the card by default; raises where
    there is none); the graph's tensors must lie there.  ``inputs``: an
    NHWC batch (cnn; tensor or numpy array) or a batch dict with
    ``tokens`` (B, S) (transformer); ``params`` optionally rebinds the
    graph's tensors (:func:`repro_torch.runtime.ir.graph_params`
    structure)."""
    dev = resolve(device)
    if params is not None:
        graph = ir.bind_params(graph, params)
    if graph.family == "cnn":
        x = torch.as_tensor(inputs, dtype=torch.float32, device=dev)
        return _execute_cnn(graph, x)
    if graph.family == "transformer":
        return _execute_transformer(graph, _batch_on(inputs, dev))
    raise ValueError(f"unknown graph family {graph.family!r}")


def _proj(x, pr, stride: int):
    """1×1 SAME projection shortcut: for k = 1 SAME needs no padding, so it
    is the strided subsample times the channel matrix."""
    w = pr["w"]
    if w.shape[0] != 1 or w.shape[1] != 1:
        raise ValueError(f"projection shortcut must be 1x1, got {w.shape}")
    return torch.matmul(x[:, ::stride, ::stride, :], w[0, 0]) + pr["b"]


def _split(t, dim: int) -> bool:
    """Whether tensor ``t`` is this rank's block along ``dim``."""
    sp = sharding_of(t)
    return sp is not None and sp.is_split(dim)


def _amax_reduce(axes):
    """The ``reduce_amax`` of a w8a8 activation split over ``axes`` (a
    max over their ranks), or None where it is whole."""
    r = active_rules()
    if r is None or not axes:
        return None
    return lambda amax: C.all_reduce(amax, r.mesh, axes, "max")


class _Channels:
    """The CNN loop's view of its activations under the ambient mesh: an
    activation is a pair ``(x, split)``, ``split`` when x holds this
    rank's block of the channels over 'model'; the batch rows are the
    rank's block over ``batch_axes`` (None: every row).  Without a mesh
    nothing is ever split and every method is the identity."""

    def __init__(self, batch_axes):
        r = active_rules()
        self.mesh = None if r is None else r.mesh
        self.batch_axes = batch_axes
        self.m = 1 if self.mesh is None else self.mesh.shape.get("model", 1)

    def whole(self, a):
        x, split = a
        return C.all_gather(x, self.mesh, "model", dim=-1) if split else x

    def local(self, a):
        x, split = a
        if split:
            return x
        c = x.shape[-1] // self.m
        return x.narrow(-1, self.mesh.index("model") * c, c).contiguous()

    def like(self, a, split: bool):
        return self.local(a) if split else self.whole(a)

    def gathered(self, t, dim: int):
        """A weight ``t`` whole along ``dim`` (gathered where split)."""
        if not _split(t, dim):
            return t
        return C.all_gather(t, self.mesh, sharding_of(t).spec[dim], dim=dim)

    def amax(self, channels_split: bool):
        axes = tuple(() if self.batch_axes is None else
                     ((self.batch_axes,) if isinstance(self.batch_axes, str)
                      else self.batch_axes))
        if channels_split:
            axes += ("model",)
        return _amax_reduce(axes)

    def rows(self, y):
        return T.gather_rows(y, self.batch_axes)

    def plan_as(self, x, w):
        """``(batch, Cout)`` of the whole product a dense conv on this
        rank's block of rows and output channels is part of, so the kernel
        sums each output in the single device's order (a w8a8 unit
        downstream then sees bitwise its activations); None without a
        mesh."""
        if self.mesh is None:
            return None
        n = x.shape[0] * (1 if self.batch_axes is None
                          else self.mesh.axis_size(self.batch_axes))
        sp = sharding_of(w)
        return n, (sp.shape[3] if sp is not None and sp.shape is not None
                   else w.shape[3])


def _conv_unit(u, a, saved, ch: _Channels):
    """conv → skip-add → concat → group norm → activation, on the pair
    ``a``; returns the output pair."""
    w, b = u.params["w"], u.params["b"]
    split = _split(w, 3)
    x = ch.local(a) if (u.depthwise and split) else ch.whole(a)
    K = w.shape[0]
    lo = (K - 1) // 2
    hi = K - 1 - lo
    if K > 1:
        x = _cnn._pad_hw(x, lo, hi)
    ws = u.params.get("w_scale")
    aq = u.quant if (ws is not None and u.quant == "w8a8") else "none"
    ra = ch.amax(u.depthwise and split) if aq == "w8a8" else None
    if u.depthwise:
        x = kernels.depthwise_conv_op(x, w, b, stride=u.stride, w_scale=ws,
                                      act_quant=aq, reduce_amax=ra)
    else:
        x = kernels.merged_conv_op(x, w, b, stride=u.stride, w_scale=ws,
                                   act_quant=aq, reduce_amax=ra,
                                   plan_as=ch.plan_as(x, w))
    if u.add_from is not None:
        base = saved[u.add_from]
        if "proj" in u.params:
            pr = u.params["proj"]
            base = (_proj(ch.whole(base), pr, u.proj_stride),
                    _split(pr["w"], 3))
        x = x + ch.like(base, split)
    if u.concat_from is not None:
        x = torch.cat([ch.whole((x, split)), ch.whole(saved[u.concat_from])],
                      dim=-1)
        split = False
    if "gn" in u.params:
        gn = u.params["gn"]
        channels = x.shape[-1] * (ch.m if split else 1)
        g = math.gcd(u.gn_groups, channels)
        if _split(gn["gamma"], 0) and g % ch.m == 0:
            x, split = _cnn._gn(ch.local((x, split)), gn, g // ch.m), True
        else:
            gn = {k: ch.gathered(v, 0) for k, v in gn.items()}
            x, split = _cnn._gn(ch.whole((x, split)), gn, u.gn_groups), False
    return _cnn._act(x, u.act), split


def _attn_unit(p, a, ch: _Channels):
    """The DDPM middle block's single-head self-attention.  With its
    weights' output channels split over 'model', each rank's q·kᵀ is a
    partial over the channels (all-reduced), its values a block of the
    channels (gathered before ``wo``)."""
    x = ch.whole(a)
    if not _split(p["wq"], 1):
        return _cnn._tiny_self_attention(x, p), False
    n, h, w, c = x.shape
    t = x.reshape(n, h * w, c)
    q, k, v = t @ p["wq"], t @ p["wk"], t @ p["wv"]
    logits = C.all_reduce(q @ k.transpose(-1, -2), ch.mesh, "model")
    att = torch.softmax(logits / math.sqrt(c), dim=-1)
    o = C.all_gather(att @ v, ch.mesh, "model", dim=-1)
    cl = p["wo"].shape[1]
    c0 = ch.mesh.index("model") * cl
    y = t[..., c0:c0 + cl] + o @ p["wo"]
    return y.reshape(n, h, w, cl), True


def _execute_cnn(graph: ir.UnitGraph, x):
    r = active_rules()
    part = None
    if r is not None:
        part = r.spec(("batch",), (x.shape[0],))[0]
        if part is not None:
            start, n = C.block(x.shape[0], r.mesh, part)
            x = x[start:start + n]
    ch = _Channels(part)
    saved: dict[int, tuple] = {}
    a = (x, False)
    if graph.meta.get("save_input"):
        saved[0] = a
    for u in graph.units:
        if u.kind == "conv":
            a = _conv_unit(u, a, saved, ch)
        elif u.kind in ("pool", "upsample"):
            x, split = a
            x = (_cnn._avg_pool_same(x, u.k, u.stride) if u.kind == "pool"
                 else _cnn._upsample(x, u.factor))
            a = (x, split)
            if u.concat_from is not None:
                a = (torch.cat([ch.whole(a), ch.whole(saved[u.concat_from])],
                               dim=-1), False)
        elif u.kind == "attn":
            a = _attn_unit(u.params, a, ch)
        else:
            raise ValueError(f"unit kind {u.kind!r} in cnn graph")
        if u.save_at is not None:
            saved[u.save_at] = a
    if graph.meta.get("head") == "classifier":
        head = graph.params["head"]
        x, split = a
        y = ch.whole((x.mean(dim=(1, 2)), split)) @ head["w"] + head["b"]
        if _split(head["w"], 1):
            y = C.all_gather(y, ch.mesh, sharding_of(head["w"]).spec[1],
                             dim=-1)
        return ch.rows(y)
    return ch.rows(ch.whole(a))


# ---------------------------------------------------------------------------
# Transformer family
# ---------------------------------------------------------------------------

def _batch_on(batch, dev) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _apply_unit(cfg, u, x, positions, mrope=None, batch_axes=None):
    """One prefill/probe unit: lowrank residual or kept sublayer (an MoE
    sublayer at the config's capacity factor).  Under a mesh: a lowrank
    unit split on 'rank' takes ``x`` through ``enter_split`` (its gradient
    summed over 'model'), keeps its residual on 'model' rank 0 and sums
    the ranks' outputs (:func:`repro_torch.models.transformer.
    merged_residual`); a sublayer sums its block's partial
    (:func:`repro_torch.models.transformer.sublayer_apply`); weights FSDP
    split over the data axes are gathered whole (their gradients
    reduce-scattered back); a w8a8 activation split over ``batch_axes``
    takes the whole batch's scale."""
    if u.kind == "lowrank":
        aq = u.quant if ("u_scale" in u.params and u.quant == "w8a8") \
            else "none"
        ra = _amax_reduce(() if batch_axes is None else batch_axes) \
            if aq == "w8a8" else None
        return T.merged_residual(u.params, x, act_quant=aq, reduce_amax=ra)
    if u.kind != "sublayer":
        raise ValueError(f"unit kind {u.kind!r} in transformer graph")
    sub = T.whole_over_data(u.params)
    h = L.rms_norm(x, sub["norm"], cfg.norm_eps)
    return x + T.sublayer_apply(cfg, u.sub_kind, sub["p"], h, positions,
                                mrope)


def run_units(cfg, units, x, positions=None):
    """Bare unit chain, no embed/unembed — the segment-probe forward."""
    if positions is None:
        positions = T.default_positions(x)
    for u in units:
        x = _apply_unit(cfg, u, x, positions)
    return x


def _execute_transformer(graph: ir.UnitGraph, batch):
    logits, _, part = _transformer_local(graph, batch)
    return T.gather_rows(logits, part)


def _transformer_local(graph: ir.UnitGraph, batch,
                       gather_vocab: bool = True):
    """``(logits of this rank's rows, its rows of the batch, their data
    axes or None)``: the prefill before the rows (and with
    ``gather_vocab=False`` the vocab slices) are gathered."""
    cfg = graph.meta["config"]
    gp = T.whole_over_data(graph.params)
    batch, part = T.local_batch(batch)
    x = T.embed_in(cfg, gp, batch)
    positions = batch.get("positions")
    if positions is None:
        positions = T.default_positions(x)
    mrope = batch.get("mrope_positions")
    for u in graph.units:
        x = _apply_unit(cfg, u, x, positions, mrope, part)
    x = L.rms_norm(x, gp["final_norm"], cfg.norm_eps)
    return T.unembed(cfg, gp, x, gather_vocab), batch, part


def execute_local(graph: ir.UnitGraph, batch, params=None, *,
                  device="cuda"):
    """A transformer graph's prefill as each rank takes its loss:
    ``(logits of this rank's rows and vocab slice, its rows of the batch,
    their data axes or None)`` (:func:`repro_torch.models.transformer.
    local_loss`'s arguments); outside a mesh the whole logits."""
    dev = resolve(device)
    if params is not None:
        graph = ir.bind_params(graph, params)
    return _transformer_local(graph, _batch_on(batch, dev),
                              gather_vocab=False)


def _is_temporal(u) -> bool:
    return u.kind == "sublayer" and u.sub_kind in ir.TEMPORAL_KINDS


def init_cache(graph: ir.UnitGraph, batch_size: int, seq_len: int):
    """Fresh per-unit decode state: a zeroed KV cache for each attention
    sublayer, the zeroed RG-LRU state ``{h, conv}``, the mLSTM state
    ``{C, n, m}`` or the sLSTM state ``{c, n, m}`` (stabilizers at
    ``-1e30``) for each recurrent one, ``{}`` for stateless units; on the
    device of the graph's tensors."""
    cfg = graph.meta["config"]
    dev = graph.params["final_norm"].device
    return [T.init_state(cfg, u.sub_kind, batch_size, seq_len, dev)
            if _is_temporal(u) else {} for u in graph.units]


def slot_state(graph: ir.UnitGraph, slots: int, seq_len: int):
    """Per-slot decode state for the continuous engine: one fresh
    batch-1 cache (:func:`init_cache`) widened to ``slots`` rows by
    :func:`repro_torch.runtime.serving.stack_cache`, each attention
    cache's ``pos`` to ``(slots,)``."""
    from .serving import stack_cache
    return stack_cache(init_cache(graph, 1, seq_len), slots)


def decode_step(graph: ir.UnitGraph, cache, batch):
    """One-token decode through the compressed unit chain: ``batch``
    ``{'tokens': (B, 1)}`` (or ``'embeds'`` (B, 1, D))[,
    ``mrope_positions`` (3, B, 1)] → ``(logits, cache)``, every state
    tensor of the cache list updated in place and nothing read on the
    host (the step can be captured in a CUDA graph).  An attention
    cache's ``pos`` is 0-d or one position per row (:func:`slot_state`).
    Lowrank units are position-independent residual maps, so each
    applies to the one-token activation directly (M = B rows)."""
    cfg = graph.meta["config"]
    gp = graph.params
    batch, part = T.local_batch(batch, T.cache_rows(cache))
    x = T.embed_in(cfg, gp, batch)
    mrope = T.mrope_of(batch, x)
    for i, u in enumerate(graph.units):
        if _is_temporal(u):
            h = L.rms_norm(x, u.params["norm"], cfg.norm_eps)
            t, cache[i] = T.temporal_decode(cfg, u.sub_kind, u.params["p"],
                                            h, cache[i], mrope)
            x = x + T.reduce_partial(cfg, u.sub_kind, u.params["p"], t)
        else:
            x = _apply_unit(cfg, u, x, None, batch_axes=part)
    x = L.rms_norm(x, gp["final_norm"], cfg.norm_eps)
    return T.gather_rows(T.unembed(cfg, gp, x), part), cache


class GraphModule(nn.Module):
    """A lowered graph as an ``nn.Module``: the graph's tensors are buffers
    (``u<i>__<keypath>`` and ``g__<keypath>``, ``/`` written ``__``), the
    statics stay on the graph."""

    def __init__(self, graph: ir.UnitGraph):
        super().__init__()
        self.graph = graph
        self._names = [{k: f"u{i}__" + k.replace("/", "__")
                        for k in flatten_tree(u.params)}
                       for i, u in enumerate(graph.units)]
        self._global_names = {k: "g__" + k.replace("/", "__")
                              for k in flatten_tree(graph.params)}
        for names, u in zip(self._names, graph.units):
            for k, v in flatten_tree(u.params).items():
                self.register_buffer(names[k], v)
        for k, v in flatten_tree(graph.params).items():
            self.register_buffer(self._global_names[k], v)

    def graph_params(self) -> dict:
        """The buffers in :func:`repro_torch.runtime.ir.graph_params` form."""
        def tree(names):
            return unflatten_tree({k: getattr(self, n)
                                   for k, n in names.items()})
        return {"units": [tree(n) for n in self._names],
                "globals": tree(self._global_names)}

    def forward(self, x):
        bufs = list(self.buffers())
        dev = bufs[0].device if bufs else torch.device("cpu")
        return execute(self.graph, x, params=self.graph_params(), device=dev)


# ---------------------------------------------------------------------------
# The graph's tensors as one tree; mesh-aware execution
# ---------------------------------------------------------------------------

def jit_apply(graph: ir.UnitGraph, *, device="cuda"):
    """``(fn(params, inputs), params)``: the forward over the graph's
    tensors as one tree (:func:`repro_torch.runtime.ir.graph_params`), on
    ``device`` — the JAX package's jitted form, a plain callable here."""
    params = ir.graph_params(graph)

    def fn(p, inputs):
        return execute(graph, inputs, params=p, device=device)
    return fn, params


def make_serve_step(graph: ir.UnitGraph):
    """``(step(params, cache, batch) → (logits, cache), params)``: the
    one-token decode over the graph's tensors as one tree, the
    artifact-backed form of :func:`repro_torch.train.step.make_serve_step`
    (run it under ``use_rules`` for a sharded graph; the serving entry
    points take ``rules=``)."""
    params = ir.graph_params(graph)

    def step(p, cache, batch):
        return decode_step(ir.bind_params(graph, p), cache, batch)
    return step, params


_STATE_AXES = {"rglru": RG.RGLRU_STATE_AXES, "mlstm": XL.MLSTM_STATE_AXES,
               "slstm": XL.SLSTM_STATE_AXES}


def _state_axes(u) -> dict:
    """Logical axes of one unit's decode state ('kv_seq' decode layout)."""
    if not _is_temporal(u):
        return {}
    if u.sub_kind in T.ATTN_KINDS:
        return dict(L.CACHE_AXES)
    return dict(_STATE_AXES[u.sub_kind])


def cache_axes(graph: ir.UnitGraph) -> list:
    """Per-unit logical-axes tree aligned with :func:`init_cache`."""
    return [_state_axes(u) for u in graph.units]


def _global_shapes(tree):
    """The global shape of every tensor of ``tree`` (a block carries it
    in its ``sharding``)."""
    if isinstance(tree, dict):
        return {k: _global_shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_global_shapes(v) for v in tree]
    sp = sharding_of(tree)
    return sp.shape if sp is not None and sp.shape is not None \
        else tuple(tree.shape)


def graph_shardings(rules, graph: ir.UnitGraph):
    """:class:`~repro_torch.sharding.rules.Placement` tree for
    :func:`ir.graph_params` under ``rules``, resolved from the graph's
    axes records with the per-leaf divisibility fallback (a dim the mesh
    does not divide stays whole): sharding stays data in the artifact."""
    return param_shardings_with_shapes(
        rules, ir.graph_axes(graph), _global_shapes(ir.graph_params(graph)))


def cache_shardings(rules, graph: ir.UnitGraph, cache):
    """Placement tree of a whole decode cache ('kv_seq' layout)."""
    return param_shardings_with_shapes(rules, cache_axes(graph), cache)


class GraphExecutor:
    """Prefill and decode over one :class:`~repro_torch.runtime.ir.UnitGraph`
    under a mesh.

    ``rules=None`` (or rules without a mesh) is the single-device
    executor: the same functions with no rules in effect.  With rules,
    every tensor of the graph that is still whole is cut to this rank's
    block of the placement its logical axes resolve to (a graph loaded
    with ``load(path, rules=)`` already holds its blocks), and
    :meth:`apply`, :meth:`init_cache` and :meth:`decode` run under the
    rules: the kernels on local shards, the collectives of
    :mod:`repro_torch.sharding.collectives`, and outputs of the
    single-device shapes on every rank.  :meth:`decode` takes the serving
    protocol's ``(cache, tokens)``, so ``ex.decode`` is a serving step."""

    def __init__(self, graph: ir.UnitGraph, rules=None):
        self.rules = rules if (rules is not None
                               and rules.mesh is not None) else None
        params = ir.graph_params(graph)
        if self.rules is not None:
            params = put(params, graph_shardings(self.rules, graph))
            graph = ir.bind_params(graph, params)
        self.graph = graph
        self.params = params
        self.device = next(iter(flatten_tree(params).values())).device

    def apply(self, batch, params=None):
        """Full forward (CNN image batch / transformer prefill)."""
        with use_rules(self.rules):
            return execute(self.graph, batch, params=params,
                           device=self.device)

    def init_cache(self, batch_size: int, seq_len: int):
        """A fresh decode state: this rank's block of it under the rules."""
        with use_rules(self.rules):
            return init_cache(self.graph, batch_size, seq_len)

    def decode(self, cache, batch, params=None):
        """One-token decode: ``batch`` a dict (``tokens`` (B, 1)) or the
        tokens themselves → ``(logits (B, 1, V), cache)``."""
        if not isinstance(batch, dict):
            batch = {"tokens": torch.as_tensor(batch, device=self.device)}
        graph = self.graph if params is None \
            else ir.bind_params(self.graph, params)
        with use_rules(self.rules):
            return decode_step(graph, cache, batch)

    def serve_step(self):
        """``(step(params, cache, batch), params)``, as
        :func:`make_serve_step`; run the step under ``use_rules(
        self.rules)`` (the serving entry points take ``rules=``)."""
        step, _ = make_serve_step(self.graph)
        return step, self.params

    def continuous_engine(self, *, slots: int, max_seq: int, **kw):
        """A :class:`repro_torch.runtime.serving.ContinuousEngine` over
        this graph, with the executor's rules; keyword extras (``chunk``,
        ``eos_id``, ``max_queue``, ``slot_nan_limit``, ``clock``, ...)
        pass through."""
        from .serving import ContinuousEngine
        return ContinuousEngine(self.decode, self.init_cache, slots=slots,
                                max_seq=max_seq, rules=self.rules, **kw)
