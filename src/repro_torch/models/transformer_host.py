"""Host adapter: transformer stacks → the generic LayerMerge core.

Sublayer chain (1-based): temporal and FFN blocks interleaved
(``transformer.sublayer_kinds``), plus a virtual ``head`` boundary at the
end (growth 0, zero latency, always kept) so segments may end at the top
of the stack.  Block capabilities:

* FFN / GLU-FFN — prunable, linearizable with growth = min(d_ff, d): the
  rank of the residual map (the Eq. 1 analogue).  Linearization folds the
  pre-norm scale ``(1 + g)`` into ``w_up``, drops ``w_gate`` and applies
  the map to the un-normalized stream — the JAX package's semantics.
* attention, MoE, RG-LRU, mLSTM and sLSTM — prunable, not linearizable
  (routing and the recurrent gates depend on the input).

A merged segment executes as one rank-k residual layer through
``merged_ffn_op`` — the hand-written ``merged_ffn`` kernel on the card —
and its latency probe runs it so (``segment_probe``), timed on the card
by the wall-clock oracle.  Plans lower to the unit IR via ``lower_plan``
and run through :mod:`repro_torch.runtime.executor`.

The host runs fp32 configs only: a bf16 config cannot be compressed (the
merged factors go through an SVD, which has no bf16 kernel in either
package) and its artifacts would not reload with their fingerprint
(ROADMAP.md queue 3).  With fp32 throughout, the probes' fp32 input and
the weights never meet in mixed dtypes.

The abstract-plan helpers at the end (:func:`abstract_plan`,
:func:`plan_units_spec`, :func:`init_compressed_model`,
:func:`compressed_model_axes`, :func:`forward_compressed_spec`) plan and
build a compressed network at production scale without weights, at any
dtype: the dry run's path (:mod:`repro_torch.launch.dryrun`).
:func:`spec_forward` trains it (sharded too) and :func:`spec_graph` gives
its unit graph.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math

import torch

from repro_torch.core import merge as M
from repro_torch.core import table_cache
from repro_torch.core.latency import CostBreakdown, matmul_cost, \
    rank_ffn_cost
from repro_torch.core.plan import CompressionPlan, LayerDesc, Segment
from repro_torch.core.probe_engine import ProbeCallable
from repro_torch.core.segments import SegmentEnumerator
from repro_torch.device import resolve
from repro_torch.kernels import quant as Q
from repro_torch.runtime import executor, ir
from repro_torch.tree import tree_map

from . import transformer as T

#: Sublayer kinds a merged segment may linearize (the rank-r residual
#: maps); every other kind is prunable only.
LINEARIZABLE = ("ffn",)
HEAD_KIND = "head"


@dataclasses.dataclass
class CostEnv:
    """Workload context of the analytic latency table and the probes.

    ``dtype_bytes`` stays the JAX package's 2 even for fp32 configs, so
    the analytic latency column is bit-identical to the JAX package's
    under its constants; it prices bf16 operands, not what the port
    moves.  ``w_bytes`` / ``act_bytes`` split the merged rank maps'
    weight and activation widths (None is ``dtype_bytes``); a quantized
    segment overrides both through ``segment_cost(seg, quant=...)``.
    """
    batch: int = 8
    seq: int = 2048
    dtype_bytes: int = 2
    w_bytes: int | None = None
    act_bytes: int | None = None
    #: Devices the batch is split over: the analytic table prices each
    #: one's ``batch · seq / chips`` tokens (the dry run's production
    #: mesh); the probes run the whole batch on one card.
    chips: int = 1


@dataclasses.dataclass
class TransformerHost:
    cfg: object
    params: dict                      # parameters on ``device``
    env: CostEnv = dataclasses.field(default_factory=CostEnv)
    max_span: int | None = None
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.cfg.dtype != "float32":
            raise ValueError(
                f"TransformerHost runs fp32 configs, got dtype="
                f"{self.cfg.dtype!r}: bf16 factors cannot go through the "
                "SVD of the rank-merge (ROADMAP.md queue 3)")
        T.check_config(self.cfg)
        self.device = resolve(self.device)
        self.kinds = T.sublayer_kinds(self.cfg) + (HEAD_KIND,)
        self.subparams = T.sublayer_params(self.cfg, self.params) + [None]
        self._descs = self._build_descs()

    # -- chain description -----------------------------------------------------
    def _build_descs(self):
        d = self.cfg.d_model
        descs = []
        for i, kind in enumerate(self.kinds):
            idx = i + 1
            if kind == HEAD_KIND:
                descs.append(LayerDesc(index=idx, kind=kind, growth=0,
                                       value=0.0, prunable=False,
                                       linearizable=False))
                continue
            p = self.subparams[i]["p"]
            val = float(sum(p[k].abs().sum() for k in sorted(p)))
            if kind == "ffn":
                descs.append(LayerDesc(
                    index=idx, kind=kind, growth=min(self.cfg.d_ff, d),
                    value=val, prunable=True, linearizable=True))
            else:
                descs.append(LayerDesc(index=idx, kind=kind, growth=0,
                                       value=val, prunable=True,
                                       linearizable=False))
        return descs

    def descs(self):
        return self._descs

    def enumerator(self, method: str = "layermerge") -> SegmentEnumerator:
        return SegmentEnumerator(
            self._descs, offset=0, cap=self.cfg.d_model,
            depth_mode=(method == "depth"), max_span=self.max_span)

    def original_k(self, l: int) -> int:
        return 0        # offset-0 convention: singleton original has k = 0

    def pruned_k(self, l: int) -> int:
        return 0

    # -- latency ------------------------------------------------------------
    def _tokens(self) -> float:
        return self.env.batch * self.env.seq / max(self.env.chips, 1)

    def _block_cost(self, kind) -> CostBreakdown:
        cfg, env = self.cfg, self.env
        d = cfg.d_model
        tokens = self._tokens()
        by = env.dtype_bytes
        if kind == HEAD_KIND:
            return CostBreakdown(0.0, 0.0)
        if kind in T.ATTN_KINDS:
            hd = cfg.head_dim
            qk = matmul_cost(tokens, d, (cfg.num_heads + cfg.num_kv_heads * 2)
                             * hd, by) + matmul_cost(tokens, cfg.num_heads * hd,
                                                     d, by)
            span = min(cfg.local_window or env.seq, env.seq)
            attn_flops = 4.0 * tokens * span * cfg.num_heads * hd
            return qk + CostBreakdown(attn_flops, tokens * span * by / 64)
        if kind == "rglru":
            dr = cfg.rnn_width or d
            return (matmul_cost(tokens, d, dr, by) * 2
                    + matmul_cost(tokens, dr, 2 * dr, by)
                    + CostBreakdown(8.0 * tokens * dr, 2 * tokens * dr * by))
        if kind == "ffn":
            mult = 3 if cfg.ffn_kind in ("swiglu", "geglu") else 2
            c = (matmul_cost(tokens, d, cfg.d_ff, by)
                 + matmul_cost(tokens, cfg.d_ff, d, by))
            return CostBreakdown(c.flops * mult / 2, c.hbm_bytes * mult / 2)
        if kind == "moe":
            # k experts a token, three products each; the token dispatch
            # and combine as link bytes (the JAX package's all-to-all
            # pair, priced at 0 s on one card by the default oracle)
            active = cfg.experts_per_token * 3
            c = matmul_cost(tokens, d, cfg.moe_dff, by)
            return CostBreakdown(c.flops * active, c.hbm_bytes * active,
                                 2.0 * tokens * d * by)
        if kind in ("mlstm", "slstm"):
            return (matmul_cost(tokens, d, 4 * d, by)
                    + CostBreakdown(12.0 * tokens * d, 4 * tokens * d * by))
        raise ValueError(kind)

    def _rank(self, seg: Segment) -> int:
        """Merged residual rank of ``seg``: ``min(k, d_model)``, 0 when
        nothing is merged."""
        interior_kept = [l for l in seg.kept if l != seg.j]
        if interior_kept or seg.j - seg.i > 1:
            return min(seg.k, self.cfg.d_model)
        return 0

    def segment_cost(self, seg: Segment, quant: str = "none"
                     ) -> CostBreakdown | None:
        """Analytic cost: the boundary block plus the merged rank map.

        ``quant`` (or ``seg.quant``) prices the rank map at narrow byte
        widths; ``None`` when a quantized cost is asked of a segment with
        no merged rank map (the kept boundary sublayer is never
        quantized): the table builder's signal that it has no quantized
        sibling."""
        q = quant if quant != "none" else seg.quant
        env = self.env
        cost = self._block_cost(self.kinds[seg.j - 1])
        rank = self._rank(seg)
        if rank > 0:
            cost = cost + rank_ffn_cost(
                self._tokens(), self.cfg.d_model, rank, env.dtype_bytes,
                w_bytes=Q.weight_bytes(q) or env.w_bytes,
                act_bytes=Q.act_bytes(q) or env.act_bytes)
        elif q != "none":
            return None
        return cost

    def probe_signature(self, seg: Segment):
        """Latency-bucketing signature: boundary kind + effective rank,
        with the workload, the byte widths and the config that fix every
        shape — weight values never enter, so one probe serves the
        bucket."""
        env = self.env
        return ("tseg", self.kinds[seg.j - 1], self._rank(seg), env.batch,
                env.seq, env.dtype_bytes, env.w_bytes, env.act_bytes,
                self.cfg)

    def segment_probe(self, seg: Segment, params=None) -> ProbeCallable:
        """The merged segment's unit chain on a zero fp32 batch of
        ``(batch, max(seq, 8), d_model)``, as (fn, args)."""
        params = params or self.params
        units = self._segment_units(seg, params)
        x = torch.zeros((max(self.env.batch, 1), max(self.env.seq, 8),
                         self.cfg.d_model), dtype=torch.float32,
                        device=self.device)
        return ProbeCallable(executor.run_units,
                             (self.cfg, units, x, T.default_positions(x)))

    def segment_callable(self, seg: Segment, params=None):
        """Zero-argument merged-segment forward for wall-clock timing."""
        return self.segment_probe(seg, params)

    def fingerprint(self) -> str:
        """Content digest for the table cache (see ``CNNHost``)."""
        h = hashlib.sha256()
        h.update(repr((self.cfg, dataclasses.astuple(self.env),
                       self.max_span, self.kinds)).encode())
        h.update(table_cache.pytree_digest(self.params).encode())
        h.update(table_cache.machine_token(self.device).encode())
        return h.hexdigest()

    # -- unit construction -----------------------------------------------------
    def _linear_factors(self, sub):
        """(U, V) of one linearized FFN: norm scale folded into W_up."""
        g = sub["norm"]
        return sub["p"]["w_up"] * (1.0 + g)[:, None], sub["p"]["w_down"]

    def _sublayer_unit(self, sub) -> ir.SublayerUnit:
        return ir.SublayerUnit(sub_kind=sub["kind"],
                               params={"norm": sub["norm"], "p": sub["p"]})

    def _segment_units(self, seg: Segment, params, merged: bool = True):
        """Lower one segment to IR units: the merged (or unmerged) rank
        maps of its kept linearizable interior + the kept boundary block."""
        units: list = []
        kept = set(seg.kept)
        subs = T.sublayer_params(self.cfg, params) + [None]
        boundary = None if self.kinds[seg.j - 1] == HEAD_KIND else seg.j
        factors = [self._linear_factors(subs[l - 1]) for l in seg.layers
                   if l != boundary and self.kinds[l - 1] != HEAD_KIND
                   and l in kept]
        if factors:
            if merged:
                u, v = M.merge_linear_residual_chain(factors)
                u, v = M.truncate_rank(u, v, self.cfg.d_model)
                qp = {"u": u.contiguous(), "v": v.contiguous()}
                if seg.quant != "none":
                    # Deployed form only: narrow u / v with a scale per
                    # output column (the replaced path stays fp).
                    uq, us = Q.quantize_weight(u, seg.quant, axis=1)
                    vq, vs = Q.quantize_weight(v, seg.quant, axis=1)
                    qp = {"u": uq, "v": vq, "u_scale": us, "v_scale": vs}
                units.append(ir.LowRankUnit(quant=seg.quant, params=qp))
            else:
                units.extend(ir.LowRankUnit(params={"u": u, "v": v})
                             for u, v in factors)
        if boundary is not None and boundary in kept:
            units.append(self._sublayer_unit(subs[boundary - 1]))
        return units

    def build_units(self, plan: CompressionPlan, params, merged: bool = True):
        units: list = []
        subs = T.sublayer_params(self.cfg, params)
        for seg in plan.segments:
            if seg.original:
                if self.kinds[seg.j - 1] != HEAD_KIND:
                    units.append(self._sublayer_unit(subs[seg.j - 1]))
                continue
            units.extend(self._segment_units(seg, params, merged=merged))
        return units

    # -- plan lowering / network builders ------------------------------------------
    def lower_plan(self, plan: CompressionPlan, params=None,
                   merged: bool = True) -> ir.UnitGraph:
        """Lower a plan to the unit IR, with frontend/head attached.

        ``merged=False`` keeps each kept FFN as its own rank map (the
        *replaced* network of Algorithm 2); ``merged=True`` composes them
        per segment (the deployed form).
        """
        params = params or self.params
        cfg = self.cfg
        units = tuple(self.build_units(plan, params, merged=merged))
        gparams = {"final_norm": params["final_norm"]}
        if cfg.frontend == "tokens":
            gparams["embed"] = params["embed"]
        if not cfg.tie_embeddings or cfg.frontend != "tokens":
            gparams["unembed"] = params["unembed"]
        return ir.annotate_axes(ir.UnitGraph(
            family="transformer", units=units, params=gparams,
            meta={"config": cfg}))

    def replaced_apply(self, plan: CompressionPlan, params=None):
        params = params or self.params

        def apply_fn(p, batch):
            return executor.execute(self.lower_plan(plan, p, merged=False),
                                    batch, device=self.device)
        return apply_fn, params

    def merged_apply(self, plan: CompressionPlan, params=None):
        params = params or self.params

        def apply_fn(p, batch):
            return executor.execute(self.lower_plan(plan, p, merged=True),
                                    batch, device=self.device)
        return apply_fn, params


# ---------------------------------------------------------------------------
# Abstract plans: a compressed network at production scale, no weights
# ---------------------------------------------------------------------------

def abstract_plan(cfg, *, budget_ratio: float, env: CostEnv, P: int = 500,
                  method: str = "layermerge", latency_oracle=None):
    """A compression plan computed without materializing parameters:
    growth-proportional ℓ1 proxies (each sublayer's value its growth, or
    ``d_model`` where it has none) and the analytic oracle (the port's
    H100 roofline by default; ``latency_oracle`` overrides it).  This is
    how the dry run lowers a LayerMerge-compressed network at full
    production scale.  ``None`` when no plan fits the budget."""
    from repro_torch.core.compress import compress as _compress

    kinds = T.sublayer_kinds(cfg) + (HEAD_KIND,)
    d = cfg.d_model
    descs = []
    for i, kind in enumerate(kinds):
        idx = i + 1
        if kind == HEAD_KIND:
            descs.append(LayerDesc(idx, kind, 0, 0.0, False, False))
        elif kind in LINEARIZABLE:
            descs.append(LayerDesc(idx, kind, min(cfg.d_ff, d),
                                   float(min(cfg.d_ff, d)), True, True))
        else:
            descs.append(LayerDesc(idx, kind, 0, float(d), True, False))
    host = TransformerHost.__new__(TransformerHost)
    host.cfg, host.env, host.kinds = cfg, env, kinds
    host.params, host.max_span = None, None
    host.device = torch.device("cpu")
    host._descs = descs
    return _compress(host, budget_ratio=budget_ratio, P=P, method=method,
                     importance="magnitude", latency_oracle=latency_oracle)


def plan_units_spec(cfg, plan) -> list:
    """Static unit descriptors of a plan: ``('merged', rank)`` |
    ``('orig', sublayer_index, kind)``, instantiable without weights."""
    kinds = T.sublayer_kinds(cfg) + (HEAD_KIND,)
    out = []
    for seg in plan.segments:
        kept = set(seg.kept)
        boundary = None if kinds[seg.j - 1] == HEAD_KIND else seg.j
        if seg.original:
            if boundary is not None:
                out.append(("orig", seg.j, kinds[seg.j - 1]))
            continue
        rank = 0
        for l in seg.layers:
            if l != boundary and kinds[l - 1] in LINEARIZABLE and l in kept:
                rank += min(cfg.d_ff, cfg.d_model)
        rank = min(rank, cfg.d_model)
        if rank > 0:
            out.append(("merged", rank))
        if boundary is not None and boundary in kept:
            out.append(("orig", boundary, kinds[boundary - 1]))
    return out


def init_compressed_model(cfg, units_spec, gen: torch.Generator | None = None,
                          device="cuda"):
    """Parameters of a compressed unit chain: ``{"units": [...],
    "final_norm", "embed"[, "unembed"]}``, a merged unit's ``u`` (D, r)
    and ``v`` (r, D) drawn at scale 0.02, a kept sublayer's ``{"norm",
    "p"}`` as the stack's init draws them, from ``gen`` (a CPU generator
    at seed 0 by default) on ``device``; on ``"meta"`` shapes and dtypes
    only, nothing drawn or allocated (the dry run's)."""
    from repro_torch.device import drawing_on, resolve

    from . import layers as L
    device = resolve(device)
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    dtype = T._dtype(cfg)
    ctx = drawing_on(device) if device.type == "meta" \
        else contextlib.nullcontext()
    with ctx:
        d = cfg.d_model
        unit_params = []
        for spec in units_spec:
            if spec[0] == "merged":
                r = spec[1]
                unit_params.append({"u": L._normal(gen, (d, r), dtype, 0.02),
                                    "v": L._normal(gen, (r, d), dtype, 0.02)})
                continue
            kind = spec[2]
            p, _ = T._init_layer(cfg, kind if kind not in ("ffn", "moe")
                                 else cfg.layer_kinds()[0], gen, dtype)
            if kind in ("ffn", "moe"):
                unit_params.append({"norm": p["norm2"], "p": p["ffn"]})
            else:
                unit_params.append({"norm": p["norm1"], "p": p["temporal"]})
        params = {"units": unit_params}
        params["final_norm"], _ = L.init_rmsnorm(d, dtype)
        if cfg.frontend == "tokens":
            params["embed"], _ = L.init_embedding(cfg.vocab_size, d, gen,
                                                  dtype)
        if not cfg.tie_embeddings or cfg.frontend != "tokens":
            params["unembed"] = L._normal(gen, (d, cfg.vocab_size), dtype,
                                          1.0 / math.sqrt(d))
    return tree_map(lambda t: t.to(device), params)


def compressed_model_axes(cfg, units_spec):
    """Logical-axes tree mirroring :func:`init_compressed_model`."""
    from . import layers as L
    from . import moe as MOE
    ax_units = []
    for spec in units_spec:
        if spec[0] == "merged":
            ax_units.append({"u": ("embed", "rank"), "v": ("rank", "embed")})
            continue
        kind = spec[2]
        if kind == "moe":
            a = MOE.moe_axes()
        elif kind == "ffn":
            a = L.ffn_axes(cfg.ffn_kind)
        else:
            a = T.temporal_axes(cfg, kind)
        ax_units.append({"norm": ("embed",), "p": a})
    axes = {"units": ax_units, "final_norm": ("embed",)}
    if cfg.frontend == "tokens":
        axes["embed"] = ("vocab", "embed")
    if not cfg.tie_embeddings or cfg.frontend != "tokens":
        axes["unembed"] = ("embed", "vocab")
    return axes


def _spec_units(units_spec, params) -> list:
    units = []
    for spec, p in zip(units_spec, params["units"]):
        if spec[0] == "merged":
            units.append(("merged", (p["u"], p["v"])))
        else:
            units.append(("orig", {"norm": p["norm"], "p": p["p"],
                                   "kind": spec[2]}))
    return units


def forward_compressed_spec(cfg, units_spec, params, batch):
    """Plan-aware forward from a spec and its params (the dry run's and
    production's path): :func:`repro_torch.models.transformer.
    forward_compressed` of the spec's units."""
    return T.forward_compressed(cfg, params, _spec_units(units_spec, params),
                                batch)


def spec_forward(cfg, units_spec):
    """``forward_fn(params, batch)`` of :func:`forward_compressed_spec`
    for :func:`repro_torch.train.step.make_train_step`, with the
    ``local`` form each rank's share of the sharded loss reads."""
    def forward_fn(params, batch):
        return forward_compressed_spec(cfg, units_spec, params, batch)

    def local(params, batch):
        return T.forward_compressed_local(
            cfg, params, _spec_units(units_spec, params), batch,
            gather_vocab=False)
    forward_fn.local = local
    return forward_fn


def spec_graph(cfg, units_spec, params) -> ir.UnitGraph:
    """The unit graph of a spec and its params (the executor's and the
    artifacts' form of the same network): a ``LowRankUnit`` per merged
    unit, a ``SublayerUnit`` per kept sublayer, the same tensors."""
    units = []
    for spec, p in zip(units_spec, params["units"]):
        if spec[0] == "merged":
            units.append(ir.LowRankUnit(params={"u": p["u"], "v": p["v"]}))
        else:
            units.append(ir.SublayerUnit(sub_kind=spec[2], params={
                "norm": p["norm"], "p": p["p"]}))
    return ir.annotate_axes(ir.UnitGraph(
        family="transformer", units=tuple(units),
        params={k: v for k, v in params.items() if k != "units"},
        meta={"config": cfg}))
