"""Host adapter: plan-aware CNNs → the generic LayerMerge core.

Gives the table builder the network's layer descriptors, segment
enumerator, analytic segment costs, shape signatures for latency
bucketing, and merged-segment probes that run exactly as the merged
segment deploys: padded, then through ``merged_conv_op`` or
``depthwise_conv_op`` — the hand-written kernels on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import kernels
from repro_torch.core.latency import CostBreakdown, conv2d_cost
from repro_torch.core.plan import CompressionPlan, LayerDesc, Segment
from repro_torch.core.probe_engine import ProbeCallable
from repro_torch.core.segments import SegmentEnumerator
from repro_torch.device import resolve
from repro_torch.runtime import executor, ir

from . import cnn


def _merged_segment_forward(x, w, b, stride, dw, lo, hi):
    if lo or hi:
        x = cnn._pad_hw(x, lo, hi)
    if dw:
        return kernels.depthwise_conv_op(x, w, b, stride=stride)
    return kernels.merged_conv_op(x, w, b, stride=stride)


@dataclasses.dataclass
class CNNHost:
    net: cnn.ConvNet
    params: dict                      # parameters on ``device``
    batch: int = 8                    # batch size for cost/latency accounting
    dtype_bytes: int = 4              # fp32 activations and weights
    max_span: int | None = None
    # None: price conv segments by the bytes the port moves on the card.
    # A budget: the JAX package's tiled traffic model under that tile
    # working set (see core.latency.conv2d_cost).
    tile_budget: float | None = None
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve(self.device)
        self._descs = self.net.layer_descs(self.params)
        self._shapes = self.net.boundary_shapes()

    # -- core protocol ---------------------------------------------------------
    def descs(self) -> list[LayerDesc]:
        return self._descs

    def enumerator(self, method: str = "layermerge") -> SegmentEnumerator:
        return SegmentEnumerator(
            self._descs, offset=1, cap=None,
            allowed_span=self.net.allowed_span,
            depth_mode=(method == "depth"),
            max_span=self.max_span)

    def original_k(self, l: int) -> int:
        return self._descs[l - 1].growth + 1

    def pruned_k(self, l: int) -> int:
        return 1

    def _is_depthwise(self, seg: Segment) -> bool:
        kept = set(seg.kept)
        return bool(kept) and all(
            self.net.spec(l).depthwise for l in seg.layers
            if l in kept and self.net.spec(l).kind == "conv")

    # -- latency ----------------------------------------------------------------
    def segment_cost(self, seg: Segment) -> CostBreakdown:
        """Analytic cost of the merged segment at its true input shape."""
        h, w, cin = self._shapes[seg.i]
        _, _, cout = self._shapes[seg.j]
        s_last = self.net.spec(seg.j)
        if s_last.kind != "conv":
            if s_last.kind == "attn":
                n = h * w
                flops = 4 * 2 * n * cin * cin + 2 * n * n * cin * 2
                return CostBreakdown(flops * self.batch,
                                     4 * n * cin * self.dtype_bytes
                                     * self.batch)
            return CostBreakdown(0.0, h * w * cin * self.dtype_bytes
                                 * self.batch * 2)
        K, S = cnn.segment_geometry(self.net, seg)
        return conv2d_cost(h, w, cin, cout, K, stride=S,
                           depthwise=self._is_depthwise(seg),
                           dtype_bytes=self.dtype_bytes, batch=self.batch,
                           tile_budget=self.tile_budget)

    def probe_signature(self, seg: Segment):
        """Shape signature bucketing this segment's latency probe: every
        input of ``segment_cost`` and of the probe's shapes."""
        h, w, cin = self._shapes[seg.i]
        _, _, cout = self._shapes[seg.j]
        s_last = self.net.spec(seg.j)
        if s_last.kind != "conv":
            return (s_last.kind, h, w, cin, s_last.k, s_last.stride,
                    self.batch, self.dtype_bytes)
        K, S = cnn.segment_geometry(self.net, seg)
        dw = self._is_depthwise(seg)
        return ("conv", h, w, cin, cout, K, S, dw, cin if dw else 1,
                self.batch, self.dtype_bytes)

    def segment_probe(self, seg: Segment, params=None) -> ProbeCallable:
        """The merged segment's forward on a zero batch, as (fn, args)."""
        params = params or self.params
        h, w, cin = self._shapes[seg.i]
        x = torch.zeros((self.batch, h, w, cin), dtype=torch.float32,
                        device=self.device)
        s_last = self.net.spec(seg.j)
        if s_last.kind == "attn":
            return ProbeCallable(cnn._tiny_self_attention,
                                 (x, params["layers"][seg.j - 1]))
        if s_last.kind == "pool":
            return ProbeCallable(cnn._avg_pool_same,
                                 (x, s_last.k, s_last.stride))
        if s_last.kind == "upsample":
            return ProbeCallable(cnn._upsample, (x, s_last.stride))
        wgt, b, stride, dw = cnn.merge_segment(self.net, params["layers"], seg)
        K = wgt.shape[0]
        lo, hi = (K - 1) // 2, (K - 1) - (K - 1) // 2
        return ProbeCallable(_merged_segment_forward,
                             (x, wgt.contiguous(), b.contiguous(), stride,
                              dw, lo, hi))

    # -- plan lowering / network builders -----------------------------------------
    def lower_plan(self, plan: CompressionPlan, params=None) -> ir.UnitGraph:
        """Lower a plan to the unit IR (Algorithm 2 final step): every
        conv segment folds into one merged convolution with explicit
        skip/concat wiring, group-norm and boundary-activation epilogues."""
        params = params or self.params
        net = self.net
        layers = params["layers"]
        need_save = {sk.start for sk in net.skips}
        add_end = {sk.end: (sk.start, i) for i, sk in enumerate(net.skips)
                   if sk.kind == "add"}
        cat_end = {sk.end: sk.start for sk in net.skips
                   if sk.kind == "concat"}
        units = []
        for seg in plan.segments:
            s_last = net.spec(seg.j)
            save_at = seg.j if seg.j in need_save else None
            if s_last.kind != "conv":
                if seg.j - seg.i != 1:
                    raise ValueError("barriers are singleton segments")
                if s_last.kind == "pool":
                    units.append(ir.PoolUnit(
                        k=s_last.k, stride=s_last.stride,
                        concat_from=cat_end.get(seg.j), save_at=save_at))
                elif s_last.kind == "upsample":
                    units.append(ir.UpsampleUnit(
                        factor=s_last.stride,
                        concat_from=cat_end.get(seg.j), save_at=save_at))
                else:
                    units.append(ir.AttnUnit(
                        save_at=save_at, params=dict(layers[seg.j - 1])))
                continue
            w, b, stride, dw = cnn.merge_segment(net, layers, seg)
            gn, gn_groups = cnn._segment_gn(net, layers, seg)
            act = s_last.act
            if net.act_after_merge and not seg.original and act == "none":
                act = "relu6"
            if seg.j >= net.L:
                act = "none"          # σ_L is the identity (paper §2)
            uparams = {"w": w.contiguous(), "b": b}
            if seg.quant != "none":
                wq, wsc = kernels.quant.quantize_weight(w, seg.quant, axis=3)
                uparams = {"w": wq, "b": b, "w_scale": wsc}
            add_from = None
            proj_stride = 1
            if seg.j in add_end:
                src, ski = add_end[seg.j]
                sk = net.skips[ski]
                if src < seg.i or sk.proj:
                    add_from = src
                    if sk.proj:
                        uparams["proj"] = dict(params["skips"][ski])
                        proj_stride = cnn._skip_stride(net, sk)
            if gn is not None:
                uparams["gn"] = dict(gn)
            units.append(ir.ConvUnit(
                stride=stride, depthwise=dw, act=act, gn_groups=gn_groups,
                proj_stride=proj_stride, add_from=add_from,
                concat_from=cat_end.get(seg.j), save_at=save_at,
                quant=seg.quant, params=uparams))
        gparams = {}
        if net.head == "classifier":
            gparams["head"] = dict(params["head"])
        return ir.annotate_axes(ir.UnitGraph(
            family="cnn", units=tuple(units), params=gparams,
            meta={"save_input": 0 in need_save, "head": net.head}))

    def replaced_apply(self, plan: CompressionPlan, params=None):
        params = params or self.params

        def apply_fn(p, x):
            return cnn.apply_replaced(self.net, p, x, plan)
        return apply_fn, params

    def merged_apply(self, plan: CompressionPlan, params=None):
        """Merged forward through the executor, re-lowered from ``p``."""
        params = params or self.params

        def apply_fn(p, x):
            return executor.execute(self.lower_plan(plan, p), x,
                                    device=self.device)
        return apply_fn, params
