"""Segment enumeration — ``K_ij`` and the Eq. 3 kept-set selection.

The paper's key structural insight is that the latency of a merged segment
depends on the kept-layer subset ``C ∩ (i, j]`` *only through the merged
size* ``k = 1 + Σ_{l∈C∩(i,j]} (Ker(θ_l) − 1)`` (kernel size for convs; the
``+1``-free rank sum for transformer blocks).  So for each segment ``(i, j]``
we enumerate the achievable sizes ``K_ij`` and, for every ``k ∈ K_ij``,
select *one* representative kept subset ``Ĉ_ijk`` — the one of maximal total
parameter ℓ1-norm (Eq. 3), which is the standard magnitude criterion of the
channel/layer-pruning literature.

The selection is an exact small DP over (layer, partial size): weights are
the per-layer growths (``Ker−1`` / rank), values are the ℓ1 norms, layers in
the irreducible set ``R`` are *forced*.  Complexity ``O(n · K₀)`` per
segment, matching the paper's ``O(L² K₀)`` table bound overall.
"""
from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np

from .plan import LayerDesc

_NEG = -math.inf


def subset_selection(
    items: Sequence[tuple[int, int, float]],
    forced: Sequence[int] = (),
    cap: int | None = None,
) -> dict[int, tuple[float, tuple[int, ...]]]:
    """Exact max-value subset per achievable weight sum.

    The weight axis is a flat NumPy array (one float row plus an
    items × weights take-bit matrix for reconstruction) rather than a dict of
    partial states, so each item is two vector ops instead of a Python loop
    over states — the same recurrence, same floats, same tie-breaking (an
    equal-value candidate never displaces the skip branch).

    Args:
      items: ``(id, weight, value)`` triples; weights are non-negative ints.
      forced: ids that must be included (the paper's ``R ∩ (i, j]``).
      cap: if given, weight sums are clamped to ``cap`` (the transformer rank
        saturates at ``d_model``); the max-value subset is kept per clamped
        key.

    Returns:
      ``{weight_sum: (total_value, kept_ids)}`` — for every achievable
      (clamped) weight sum, the maximum total value and one argmax subset.
    """
    forced_set = set(forced)
    n = len(items)
    W = sum(w for _, w, _ in items)
    values = np.full(W + 1, _NEG, dtype=np.float64)
    values[0] = 0.0
    took = np.zeros((n, W + 1), dtype=bool)
    for idx, (ident, w, v) in enumerate(items):
        shifted = np.full(W + 1, _NEG)
        np.add(values[:W + 1 - w], v, out=shifted[w:])
        if ident in forced_set:
            took[idx] = shifted != _NEG
            values = shifted
        else:
            upd = shifted > values          # strict: ties keep the skip branch
            took[idx] = upd
            values = np.where(upd, shifted, values)

    def backtrack(wt: int) -> tuple[int, ...]:
        ids = []
        t = wt
        for idx in range(n - 1, -1, -1):
            ident, w, _v = items[idx]
            if took[idx, t]:
                ids.append(ident)
                t -= w
        return tuple(sorted(ids))

    reachable = [int(wt) for wt in np.nonzero(values != _NEG)[0]]
    if cap is None:
        return {wt: (float(values[wt]), backtrack(wt)) for wt in reachable}
    clamped: dict[int, int] = {}
    for wt in reachable:                    # ascending: ties keep smallest wt
        key = min(wt, cap)
        if key not in clamped or values[wt] > values[clamped[key]]:
            clamped[key] = wt
    return {key: (float(values[wt]), backtrack(wt))
            for key, wt in clamped.items()}


def pareto_prune_options(
    opts: Mapping[int, tuple[float, float, tuple[int, ...]]],
) -> dict[int, tuple[float, float, tuple[int, ...]]]:
    """Drop dominated ``k → (I, T, kept)`` options within one span.

    Option ``a`` dominates ``b`` when ``I_a ≥ I_b`` and ``T_a ≤ T_b`` (ties
    resolved toward the smaller ``k``).  Dominated options can never appear
    in an optimal plan of Problem 5 — the DP maximizes ΣI under a ΣT budget,
    so swapping a dominated pick for its dominator keeps feasibility and
    does not lower the objective.  Pruning therefore preserves the DP's
    optimum exactly while shrinking the candidate set it sweeps.

    Keys may be plain ints or ``(k, quant-mode)`` precision siblings (see
    :data:`repro_torch.core.dp.TableFn`); the tie-break key normalizes both so
    mixed tables sort deterministically — fp before quantized at equal
    ``(T, I, k)``, identical order to before on fp-only tables.
    """
    def keyf(kv):
        from .dp import split_key
        k, mode = split_key(kv[0])
        return (kv[1][1], -kv[1][0], k, mode != "none", mode)

    ordered = sorted(opts.items(), key=keyf)
    out: dict[int, tuple[float, float, tuple[int, ...]]] = {}
    best_i = _NEG
    for k, (imp, lat, kept) in ordered:
        if imp > best_i:
            out[k] = (imp, lat, kept)
            best_i = imp
    return out


class SegmentEnumerator:
    """Computes ``K_ij`` and ``Ĉ_ijk`` for a chain of :class:`LayerDesc`.

    Two conventions, selected by ``offset``:

    * CNN (``offset=1``): merged size ``k = 1 + Σ (Ker−1)`` over kept convs —
      the interior of ``(i, j]`` is *all* of ``i+1..j`` and the boundary
      activation ``σ_j`` is kept (Eq. 1 of the paper).
    * Transformer (``offset=0``): merged size = Σ rank over kept linearized
      blocks, clamped at ``cap=d_model``.

    ``barriers`` lets a host forbid segment spans (skip-concat boundaries,
    strided-conv restriction, attention kept-blocks, …) via a predicate.
    """

    def __init__(
        self,
        descs: Sequence[LayerDesc],
        *,
        offset: int = 1,
        cap: int | None = None,
        allowed_span=None,        # (i, j) -> bool
        depth_mode: bool = False,  # Depth baseline (Kim et al. 2023): C = [L]
        max_span: int | None = None,
    ):
        self.descs = list(descs)
        self.L = len(self.descs)
        self.offset = offset
        self.cap = cap
        self.allowed_span = allowed_span or (lambda i, j: True)
        self.depth_mode = depth_mode
        self.max_span = max_span

    def options(self, i: int, j: int) -> dict[int, tuple[float, tuple[int, ...]]]:
        """All ``k → (ℓ1 value, Ĉ_ijk)`` choices for segment ``(i, j]``.

        Returns an empty dict when the span is not mergeable (a
        non-linearizable, non-prunable layer sits strictly inside, or the
        host's span predicate rejects it).
        """
        if not (0 <= i < j <= self.L):
            raise ValueError(f"bad segment ({i}, {j}]")
        if self.max_span is not None and (j - i) > self.max_span:
            return {}
        if not self.allowed_span(i, j):
            return {}
        layers = self.descs[i:j]            # descs are 0-indexed; layer l = descs[l-1]
        interior = layers[:-1] if self.offset == 0 else layers
        boundary = layers[-1] if self.offset == 0 else None

        # Singleton fallback (CNN convention): a barrier unit (pool /
        # upsample / attention) can only be kept exactly as-is.
        if self.offset == 1 and j - i == 1 and not layers[0].linearizable:
            d = layers[0]
            return {d.growth + self.offset: (d.value, (d.index,))}

        items: list[tuple[int, int, float]] = []
        forced: list[int] = []
        # Stride-aware growth (CNN convention): a kept conv after a stride-s
        # prefix grows the merged kernel by (Ker−1)·s (Eq. 1 with strides),
        # so the k coordinate stays the *true* merged kernel size on strided
        # spans.  Strided layers are never prunable (not shape-preserving),
        # hence the prefix product is deterministic per span.  Hosts without
        # stride metadata (transformers) see s ≡ 1 — weights unchanged.
        s_prefix = 1
        for d in interior:
            if d.linearizable:
                items.append((d.index, d.growth * s_prefix, d.value))
                if not d.prunable:
                    forced.append(d.index)
            s_prefix *= int(d.meta.get("stride", 1)) if d.meta else 1
            if not d.linearizable:
                # Non-linearizable layer strictly inside a merged segment: it
                # must be pruned; if it cannot be pruned the span is invalid.
                if not d.prunable:
                    return {}
        if self.depth_mode:
            # Depth baseline: every layer is kept — exactly one k per span.
            forced = [d.index for d in interior if d.linearizable]
            if any(not d.linearizable for d in interior):
                return {}

        sel = subset_selection(items, forced=forced, cap=self.cap)
        out: dict[int, tuple[float, tuple[int, ...]]] = {}
        for w, (val, kept) in sel.items():
            k = w + self.offset
            kept_ids = kept
            if boundary is not None:
                # Transformer convention: the boundary block j is kept as-is.
                kept_ids = tuple(sorted(kept + (boundary.index,)))
                val = val + boundary.value
            out[k] = (val, kept_ids)
        if self.depth_mode and len(out) > 1:   # defensive: must be single-k
            k = max(out)
            out = {k: out[k]}
        return out

    def singleton_original_k(self, j: int) -> int:
        """The ``k`` coordinate of keeping layer ``j`` exactly as-is."""
        return self.descs[j - 1].growth + self.offset

    def all_spans(self):
        for i in range(self.L):
            for j in range(i + 1, self.L + 1):
                opts = self.options(i, j)
                if opts:
                    yield i, j, opts


def table_entry_count(enum: SegmentEnumerator) -> int:
    """Number of (i, j, k) lookup-table entries (paper Table 7/8 metric)."""
    return sum(len(opts) for _, _, opts in enum.all_spans())
