"""UnitGraph interpreter for merged CNNs.

Every conv unit runs through the public kernel entry points
(:mod:`repro_torch.kernels`): the hand-written CUDA kernels on the card,
their plain PyTorch versions on the CPU — so serving exercises exactly the
kernels the latency tables timed.  The epilogue order is the JAX package's
(``runtime/executor.py``): the kernel is called without an activation,
then skip-add (through the 1×1 projection when the unit has one), concat,
group norm, and the boundary activation.

* :func:`execute` — full forward of an NHWC image batch.
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

from . import ir
from .artifact import flatten_tree, unflatten_tree


def execute(graph: ir.UnitGraph, inputs, params=None, *, device="cuda"):
    """Run a CNN UnitGraph on ``device`` (the card by default; raises where
    there is none).  ``inputs``: NHWC batch (tensor or numpy array);
    ``params`` optionally rebinds the graph's tensors
    (:func:`repro_torch.runtime.ir.graph_params` structure)."""
    dev = resolve(device)
    if params is not None:
        graph = ir.bind_params(graph, params)
    if graph.family != "cnn":
        raise NotImplementedError(
            f"graph family {graph.family!r} is not ported (only 'cnn' is)")
    x = torch.as_tensor(inputs, dtype=torch.float32, device=dev)
    return _execute_cnn(graph, x)


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
