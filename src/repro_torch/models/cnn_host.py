"""Host adapter: plan-aware CNNs → the generic LayerMerge core.

Gives the table builder the network's layer descriptors, segment
enumerator, analytic segment costs, shape signatures for latency
bucketing, and merged-segment probes that run exactly as the merged
segment deploys: padded, then through ``merged_conv_op`` or
``depthwise_conv_op`` — the hand-written kernels on the card — and
Dirac-masked span batches for the vmapped Eq. 4 fine-tunes
(:meth:`CNNHost.importance_batch`).
"""
from __future__ import annotations

import dataclasses
import hashlib

import torch
from torch.utils import _pytree as pytree

from repro_torch import kernels
from repro_torch.core import table_cache
from repro_torch.core.latency import CostBreakdown, conv2d_cost
from repro_torch.core.plan import CompressionPlan, LayerDesc, Segment
from repro_torch.core.probe_engine import ProbeCallable
from repro_torch.core.segments import SegmentEnumerator
from repro_torch.core.tables import one_segment_plan
from repro_torch.device import resolve
from repro_torch.runtime import executor, ir

from . import cnn


def _dirac_like(w: torch.Tensor, depthwise: bool) -> torch.Tensor:
    """Identity stand-in for a pruned conv, at the conv's own kernel shape.

    A ``k×k`` kernel that is a centred delta (times the channel identity)
    computes exactly the input's centre crop: every off-centre tap
    multiplies by 0.0 and the centre tap by 1.0.  Substituting it for a
    pruned conv inside an all-kept span graph reproduces the replaced
    network (which pads less and skips the layer) while keeping one
    shared graph for every kept set of the span — the structural trick
    behind the vmapped importance batch.  Requires odd ``k``.
    """
    kh, kw, cin, cout = w.shape
    out = torch.zeros_like(w)
    c0, c1 = (kh - 1) // 2, (kw - 1) // 2
    if depthwise:
        out[c0, c1, 0, :] = 1.0
    else:
        out[c0, c1] = torch.eye(cin, cout, dtype=w.dtype, device=w.device)
    return out


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
    # Split weight / activation byte widths of the cost model; None is
    # ``dtype_bytes`` (bit-identical fp costs).  A quantized segment
    # overrides both through ``segment_cost(seg, quant=...)``.
    w_bytes: int | None = None
    act_bytes: int | None = None

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
    def segment_cost(self, seg: Segment, quant: str = "none"
                     ) -> CostBreakdown | None:
        """Analytic cost of the merged segment at its true input shape.

        ``quant`` (or ``seg.quant``) prices it at narrow byte widths —
        int8 / fp8 weights, int8 activations under 'w8a8'.  ``None`` when
        a quantized cost is asked of a segment the quantized kernels do
        not run (a pool, upsample or attention barrier): the table
        builder's signal that the span has no quantized sibling.
        """
        q = quant if quant != "none" else seg.quant
        h, w, cin = self._shapes[seg.i]
        _, _, cout = self._shapes[seg.j]
        s_last = self.net.spec(seg.j)
        if s_last.kind != "conv":
            if q != "none":
                return None
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
                           tile_budget=self.tile_budget,
                           w_bytes=kernels.quant.weight_bytes(q)
                           or self.w_bytes,
                           act_bytes=kernels.quant.act_bytes(q)
                           or self.act_bytes)

    def probe_signature(self, seg: Segment):
        """Shape signature bucketing this segment's latency probe: every
        input of ``segment_cost`` and of the probe's shapes, ending in the
        host's byte widths (the JAX package's signature)."""
        h, w, cin = self._shapes[seg.i]
        _, _, cout = self._shapes[seg.j]
        s_last = self.net.spec(seg.j)
        if s_last.kind != "conv":
            return (s_last.kind, h, w, cin, s_last.k, s_last.stride,
                    self.batch, self.dtype_bytes, self.w_bytes,
                    self.act_bytes)
        K, S = cnn.segment_geometry(self.net, seg)
        dw = self._is_depthwise(seg)
        return ("conv", h, w, cin, cout, K, S, dw, cin if dw else 1,
                self.batch, self.dtype_bytes, self.w_bytes, self.act_bytes)

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

    def segment_callable(self, seg: Segment, params=None):
        """Zero-argument merged-segment forward for wall-clock timing."""
        return self.segment_probe(seg, params)

    def fingerprint(self) -> str:
        """Content digest for the table cache: the network's structure,
        the probe workload and cost model, the parameters' bytes and the
        machine token (wall-clock latencies do not transfer between
        cards)."""
        h = hashlib.sha256()
        h.update(repr((self.net, self.batch, self.dtype_bytes,
                       self.max_span, self.w_bytes, self.act_bytes,
                       self.tile_budget)).encode())
        h.update(table_cache.pytree_digest(self.params).encode())
        h.update(table_cache.machine_token(self.device).encode())
        return h.hexdigest()

    # -- batched importance probes ---------------------------------------------
    def importance_batch(self, segs: list[Segment], params=None):
        """One shared apply + stacked candidates for a span's Eq. 4 probes,
        as ``(apply_fn, stacked, grad_mask)``.

        Every probe of span ``(i, j]`` is expressed on one graph — the
        all-kept replaced network — by substituting a centred Dirac kernel
        (:func:`_dirac_like`) for each pruned conv and zeroing its bias.
        The candidates then differ only in leaf values, so the engine can
        stack them and vmap the fine-tune.  ``grad_mask`` freezes the
        Dirac leaves: updating them would turn "no layer" into a free
        extra conv and change Eq. 4's semantics.  Returns None (the
        engine's scalar fallback) when the span holds non-conv units,
        normed convs (BN/GN folding changes the fine-tune
        parametrization) or even kernels (no centred delta).
        """
        params = params or self.params
        seg0 = segs[0]
        span = tuple(range(seg0.i + 1, seg0.j + 1))
        for l in span:
            s = self.net.spec(l)
            if s.kind != "conv" or s.norm is not None or s.k % 2 == 0:
                return None
        probe = Segment(i=seg0.i, j=seg0.j, k=0, kept=span)
        K_all, _ = cnn.segment_geometry(self.net, probe)
        probe = Segment(i=seg0.i, j=seg0.j, k=K_all, kept=span)
        apply_fn, _ = self.replaced_apply(one_segment_plan(self, probe),
                                          params)
        ones = pytree.tree_map(
            lambda x: torch.ones((), dtype=x.dtype, device=x.device), params)
        cands, masks = [], []
        for seg in segs:
            kept = set(seg.kept)
            layers = list(params["layers"])
            mlayers = [dict(m) for m in ones["layers"]]
            for l in span:
                if l in kept:
                    continue
                p, mp = dict(layers[l - 1]), mlayers[l - 1]
                p["w"] = _dirac_like(p["w"], self.net.spec(l).depthwise)
                mp["w"] = torch.zeros_like(mp["w"])
                if "b" in p:
                    p["b"] = torch.zeros_like(p["b"])
                    mp["b"] = torch.zeros_like(mp["b"])
                layers[l - 1] = p
            cands.append({**params, "layers": layers})
            masks.append({**ones, "layers": mlayers})
        return apply_fn, _stack(cands), _stack(masks)

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


def _stack(trees):
    """Stack same-structured trees of tensors leaf by leaf (a new leading
    axis)."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *trees)
