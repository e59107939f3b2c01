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
* :func:`init_cache` / :func:`decode_step` — one-token decode through a
  compressed transformer: a KV cache per attention sublayer, the
  recurrent state per RG-LRU sublayer; lowrank units carry no state.
  :func:`slot_state` is the continuous engine's per-slot state.
* :class:`GraphModule` — an ``nn.Module`` holding a graph's tensors as
  buffers (so ``.to(device)`` moves them), whose ``forward`` is
  :func:`execute`.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import kernels
from repro_torch.device import resolve
from repro_torch.models import cnn as _cnn
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

from . import ir
from .artifact import flatten_tree, unflatten_tree


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


def _execute_cnn(graph: ir.UnitGraph, x):
    saved: dict[int, torch.Tensor] = {}
    if graph.meta.get("save_input"):
        saved[0] = x
    for u in graph.units:
        if u.kind == "conv":
            w, b = u.params["w"], u.params["b"]
            K = w.shape[0]
            lo = (K - 1) // 2
            hi = K - 1 - lo
            if K > 1:
                x = _cnn._pad_hw(x, lo, hi)
            ws = u.params.get("w_scale")
            aq = u.quant if (ws is not None and u.quant == "w8a8") else "none"
            if u.depthwise:
                x = kernels.depthwise_conv_op(x, w, b, stride=u.stride,
                                              w_scale=ws, act_quant=aq)
            else:
                x = kernels.merged_conv_op(x, w, b, stride=u.stride,
                                           w_scale=ws, act_quant=aq)
            if u.add_from is not None:
                base = saved[u.add_from]
                if "proj" in u.params:
                    base = _proj(base, u.params["proj"], u.proj_stride)
                x = x + base
            if u.concat_from is not None:
                x = torch.cat([x, saved[u.concat_from]], dim=-1)
            if "gn" in u.params:
                x = _cnn._gn(x, u.params["gn"], u.gn_groups)
            x = _cnn._act(x, u.act)
        elif u.kind == "pool":
            x = _cnn._avg_pool_same(x, u.k, u.stride)
            if u.concat_from is not None:
                x = torch.cat([x, saved[u.concat_from]], dim=-1)
        elif u.kind == "upsample":
            x = _cnn._upsample(x, u.factor)
            if u.concat_from is not None:
                x = torch.cat([x, saved[u.concat_from]], dim=-1)
        elif u.kind == "attn":
            x = _cnn._tiny_self_attention(x, u.params)
        else:
            raise ValueError(f"unit kind {u.kind!r} in cnn graph")
        if u.save_at is not None:
            saved[u.save_at] = x
    if graph.meta.get("head") == "classifier":
        head = graph.params["head"]
        x = x.mean(dim=(1, 2)) @ head["w"] + head["b"]
    return x


# ---------------------------------------------------------------------------
# Transformer family
# ---------------------------------------------------------------------------

def _batch_on(batch, dev) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def _apply_unit(cfg, u, x, positions):
    """One prefill/probe unit: lowrank residual or kept sublayer."""
    if u.kind == "lowrank":
        us, vs = u.params.get("u_scale"), u.params.get("v_scale")
        aq = u.quant if (us is not None and u.quant == "w8a8") else "none"
        return kernels.merged_ffn_op(x, u.params["u"], u.params["v"],
                                     u_scale=us, v_scale=vs, act_quant=aq)
    if u.kind != "sublayer":
        raise ValueError(f"unit kind {u.kind!r} in transformer graph")
    sub = u.params
    h = L.rms_norm(x, sub["norm"], cfg.norm_eps)
    if u.sub_kind == "ffn":
        t = L.ffn(sub["p"], h, cfg.ffn_kind)
    else:
        t = T.temporal_apply(cfg, u.sub_kind, sub["p"], h, positions)
    return x + t


def run_units(cfg, units, x, positions=None):
    """Bare unit chain, no embed/unembed — the segment-probe forward."""
    if positions is None:
        positions = T.default_positions(x)
    for u in units:
        x = _apply_unit(cfg, u, x, positions)
    return x


def _execute_transformer(graph: ir.UnitGraph, batch):
    cfg = graph.meta["config"]
    gp = graph.params
    x = T.embed_in(cfg, gp, batch)
    positions = batch.get("positions")
    if positions is None:
        positions = T.default_positions(x)
    for u in graph.units:
        x = _apply_unit(cfg, u, x, positions)
    x = L.rms_norm(x, gp["final_norm"], cfg.norm_eps)
    return T.unembed(cfg, gp, x)


def _is_temporal(u) -> bool:
    return u.kind == "sublayer" and u.sub_kind in ir.TEMPORAL_KINDS


def init_cache(graph: ir.UnitGraph, batch_size: int, seq_len: int):
    """Zeroed per-unit decode state: a KV cache for each attention
    sublayer, the RG-LRU state ``{h, conv}`` for each recurrent one,
    ``{}`` for stateless units; on the device of the graph's tensors."""
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
    ``{'tokens': (B, 1)}`` → ``(logits, cache)``, every state tensor of
    the cache list updated in place and nothing read on the host (the
    step can be captured in a CUDA graph).  An attention cache's ``pos``
    is 0-d or one position per row (:func:`slot_state`).  Lowrank units
    are position-independent residual maps, so each applies to the
    one-token activation directly (M = B rows)."""
    cfg = graph.meta["config"]
    gp = graph.params
    x = T.embed_in(cfg, gp, batch)
    for i, u in enumerate(graph.units):
        if _is_temporal(u):
            h = L.rms_norm(x, u.params["norm"], cfg.norm_eps)
            t, cache[i] = T.temporal_decode(cfg, u.sub_kind, u.params["p"],
                                            h, cache[i])
            x = x + t
        else:
            x = _apply_unit(cfg, u, x, None)
    x = L.rms_norm(x, gp["final_norm"], cfg.norm_eps)
    return T.unembed(cfg, gp, x), cache


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
