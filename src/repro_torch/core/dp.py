"""Algorithm 1 — the exact DP for the surrogate problem (Problem 5).

Also provides:

* :func:`solve_dp_reference` — the original scalar solver, kept as the
  bit-exact oracle for the vectorized fast path;
* :func:`solve_knapsack` — the paper's *LayerOnly* baseline (Problem 8), a
  0-1 knapsack over whole layers solved exactly on the same latency grid;
* :func:`brute_force` — an exponential reference solver used by the property
  tests to certify Theorem 3.1 (DP == optimum) on small instances.

Latency discretization follows the paper: every table latency is floored to
the grid ``{T0/P, 2·T0/P, …, T0}`` (integer units of ``T0/P``).  With integer
unit latencies the DP is exact; with real latencies it is exact for the
floored instance, as in the paper.

The fast path vectorizes the budget axis: for each layer ``l`` and candidate
``(l', k)`` the whole row ``M[l', :]`` is shifted by the discretized latency
and folded into a running max, so the per-budget Python loop of the scalar
solver becomes two NumPy ops per candidate.  Candidates are visited in the
scalar solver's order and only strictly-greater values replace the running
max, so plans (not just objectives) are bit-identical to the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import numpy as np

from .plan import CompressionPlan, Segment

NEG = -math.inf

# TableFn: (i, j) -> {k: (importance I[i,j,k], latency T[i,j,k], kept ids)}.
# The per-segment candidate axis is widened for precision planning: a key
# is either the plain merged-size int ``k`` (fp) or a ``(k, mode)`` tuple
# naming a quantized sibling (mode ∈ repro_torch.kernels.quant.MODES).  Every
# solver splits keys through :func:`split_key`; fp-only tables keep int
# keys and visit order, so their plans stay bit-identical.
TableFn = Callable[[int, int], Mapping[int, tuple[float, float, tuple[int, ...]]]]


def split_key(key) -> tuple[int, str]:
    """``(k, quant-mode)`` from a table option key (int k ⇒ fp 'none')."""
    if isinstance(key, tuple):
        return int(key[0]), key[1]
    return int(key), "none"


@dataclasses.dataclass
class DPResult:
    plan: CompressionPlan
    objective: float
    latency: float          # true (undiscretized) latency sum
    table_M: np.ndarray     # the DP value table, for inspection/tests


def _discretize(t: float, unit: float) -> int:
    """Floor a latency to grid units (paper §3.3 / Appendix C)."""
    return int(math.floor(t / unit + 1e-9))


def _collect_span_opts(L: int, table: TableFn):
    """Materialize non-empty span options once, for solve + reconstruction."""
    span_opts: dict[tuple[int, int], Mapping[int, tuple[float, float, tuple[int, ...]]]] = {}
    for j in range(1, L + 1):
        for i in range(j - 1, -1, -1):
            opts = table(i, j)
            if opts:
                span_opts[(i, j)] = opts
    return span_opts


@dataclasses.dataclass
class _FlatSpanOpts:
    """All (i, j, k) candidates as flat arrays, in the scalar solver's visit
    order: for each end layer ``l``, spans by ascending start ``lp``, then
    table insertion order.  ``offsets[l] : offsets[l + 1]`` indexes layer
    ``l``'s candidates; ``kept`` is the one per-candidate Python object
    (needed only at reconstruction, never in the hot loop).
    """

    lp: np.ndarray          # int32  (n,) span start
    k: np.ndarray           # int32  (n,) merged-size coordinate
    imp: np.ndarray         # float64 (n,) importance I[i,j,k]
    lat: np.ndarray         # float64 (n,) true latency T[i,j,k]
    kept: list              # tuple[int, ...] per candidate
    quant: list             # str quant mode per candidate ('none' for fp)
    offsets: np.ndarray     # int64 (L + 2,)


def _flatten_span_opts(L: int, table: TableFn) -> _FlatSpanOpts:
    """One span walk → flat candidate arrays (the only Python-loop pass)."""
    lp: list[int] = []
    ks: list[int] = []
    imp: list[float] = []
    lat: list[float] = []
    kept: list = []
    quant: list = []
    offsets = np.zeros(L + 2, dtype=np.int64)
    for l in range(1, L + 1):
        for i in range(l):
            for key, (iv, tv, kv) in table(i, l).items():
                k, mode = split_key(key)
                lp.append(i)
                ks.append(k)
                imp.append(iv)
                lat.append(tv)
                kept.append(kv)
                quant.append(mode)
        offsets[l + 1] = len(lp)
    return _FlatSpanOpts(
        lp=np.asarray(lp, dtype=np.int32),
        k=np.asarray(ks, dtype=np.int32),
        imp=np.asarray(imp, dtype=np.float64),
        lat=np.asarray(lat, dtype=np.float64),
        kept=kept,
        quant=quant,
        offsets=offsets)


def _build_result(L, T0, P, M, segs_rev, method) -> DPResult:
    segs = list(reversed(segs_rev))
    true_lat = sum(s_lat for _, s_lat in segs)
    plan = CompressionPlan(num_layers=L, segments=tuple(s for s, _ in segs),
                           objective=float(M[L, P]), latency=true_lat,
                           budget=T0, method=method)
    return DPResult(plan=plan, objective=float(M[L, P]), latency=true_lat,
                    table_M=M)


def solve_dp(
    L: int,
    table: TableFn,
    T0: float,
    P: int,
    *,
    method: str = "layermerge",
    original_k: Callable[[int], int] | None = None,
) -> DPResult | None:
    """Exact DP of Algorithm 1 — vectorized over the budget axis.

    ``table(i, j)`` returns the merged-segment options for span ``(i, j]``
    (empty if the span is not mergeable).  Returns ``None`` when no feasible
    plan exists within ``T0`` (budget too tight even for the cheapest plan).
    Bit-identical to :func:`solve_dp_reference`, including tie-breaking.
    """
    if T0 <= 0 or P <= 0:
        raise ValueError("T0 and P must be positive")
    unit = T0 / P
    flat = _flatten_span_opts(L, table)
    # Vectorized latency discretization: same floor + epsilon as
    # _discretize, over every candidate at once.
    td_all = np.floor(flat.lat / unit + 1e-9).astype(np.int64)

    # M[l, t]: best Σ I over the first l layers with budget index t (0..P).
    M = np.full((L + 1, P + 1), NEG, dtype=np.float64)
    M[0, :] = 0.0
    # choice[l, t]: flat candidate index of the winning candidate.
    choice = np.full((L + 1, P + 1), -1, dtype=np.int64)
    row_reachable = np.zeros(L + 1, dtype=bool)
    row_reachable[0] = True

    lp_all, imp_all, off = flat.lp, flat.imp, flat.offsets
    cand = np.empty(P + 1, dtype=np.float64)
    for l in range(1, L + 1):
        lo, hi = off[l], off[l + 1]
        best = M[l]
        if hi > lo:
            # feasibility + reachability filtered as one vector op; skipped
            # candidates could never win (all-NEG rows, off-grid budgets),
            # so the visit order of the survivors matches the reference.
            live = np.nonzero((td_all[lo:hi] <= P)
                              & row_reachable[lp_all[lo:hi]])[0] + lo
            ch = choice[l]
            for ci in live:
                td = td_all[ci]
                # cand[t] = M[lp, t - td] + imp for t >= td, NEG below — the
                # scalar solver's inner t-loop as one shifted vector add.
                cand[:td] = NEG
                np.add(M[lp_all[ci], :P + 1 - td], imp_all[ci], out=cand[td:])
                upd = cand > best                  # strict: first max wins,
                best[upd] = cand[upd]              # matching the reference
                ch[upd] = ci
        row_reachable[l] = bool(np.max(best) != NEG)

    if M[L, P] == NEG:
        return None

    # -- reconstruct A*, C*, k* ----------------------------------------------
    segs_rev: list[tuple[Segment, float]] = []
    l, t = L, P
    while l > 0:
        ci = choice[l, t]
        lp, k = int(flat.lp[ci]), int(flat.k[ci])
        lat, kept = float(flat.lat[ci]), flat.kept[ci]
        orig = (original_k is not None and l - lp == 1
                and k == original_k(l) and set(kept) == {l})
        segs_rev.append((Segment(i=lp, j=l, k=k, kept=kept, original=orig,
                                 quant=flat.quant[ci]), lat))
        l, t = lp, t - int(td_all[ci])
    return _build_result(L, T0, P, M, segs_rev, method)


def solve_dp_reference(
    L: int,
    table: TableFn,
    T0: float,
    P: int,
    *,
    method: str = "layermerge",
    original_k: Callable[[int], int] | None = None,
) -> DPResult | None:
    """The original scalar DP — the certification oracle for :func:`solve_dp`."""
    if T0 <= 0 or P <= 0:
        raise ValueError("T0 and P must be positive")
    unit = T0 / P
    span_opts = _collect_span_opts(L, table)

    M = np.full((L + 1, P + 1), NEG, dtype=np.float64)
    M[0, :] = 0.0
    back: dict[tuple[int, int], tuple] = {}

    for l in range(1, L + 1):
        for lp in range(l):
            opts = span_opts.get((lp, l))
            if not opts:
                continue
            for key, (imp, lat, kept) in opts.items():
                k, mode = split_key(key)
                td = _discretize(lat, unit)
                if td > P:
                    continue
                for t in range(td, P + 1):
                    prev = M[lp, t - td]
                    if prev == NEG:
                        continue
                    cand = prev + imp
                    if cand > M[l, t]:
                        M[l, t] = cand
                        back[(l, t)] = (lp, k, td, lat, kept, mode)

    if M[L, P] == NEG:
        return None

    segs_rev: list[tuple[Segment, float]] = []
    l, t = L, P
    while l > 0:
        lp, k, td, lat, kept, mode = back[(l, t)]
        orig = (original_k is not None and l - lp == 1
                and k == original_k(l) and set(kept) == {l})
        segs_rev.append((Segment(i=lp, j=l, k=k, kept=kept, original=orig,
                                 quant=mode), lat))
        l, t = lp, t - td
    return _build_result(L, T0, P, M, segs_rev, method)


def solve_knapsack(
    L: int,
    importance: Mapping[int, float],
    latency: Mapping[int, float],
    T0: float,
    P: int,
    *,
    forced: tuple[int, ...] = (),
) -> tuple[tuple[int, ...], float, float] | None:
    """*LayerOnly* baseline (Problem 8): exact 0-1 knapsack on the grid.

    ``M[t]`` is the best value with discretized weight ≤ ``t``; with zero
    layers processed every budget holds value 0, and forced layers replace
    the row outright (no skip branch), so forced-infeasible budgets carry an
    explicit ``NEG`` instead of a keep-flag recorded off a ``NEG``
    predecessor.  Returns ``(C*, objective, true_latency)`` — the kept layer
    set — or ``None`` if the forced set cannot fit the budget.
    """
    if T0 <= 0 or P <= 0:
        raise ValueError("T0 and P must be positive")
    unit = T0 / P
    forced_set = set(forced)
    M = np.zeros(P + 1, dtype=np.float64)     # zero layers: 0 at every budget
    keep = np.zeros((L + 1, P + 1), dtype=bool)
    tds = {}
    for l in range(1, L + 1):
        imp, lat = importance[l], latency[l]
        td = tds[l] = _discretize(lat, unit)
        take = np.full(P + 1, NEG)
        if td <= P:
            np.add(M[:P + 1 - td], imp, out=take[td:])
        if l in forced_set:
            # forced: the skip branch does not exist; infeasible stays NEG.
            keep[l] = take != NEG
            M = take
        else:
            # tie prefers take, but never records keep on an infeasible take.
            upd = (take >= M) & (take != NEG)
            keep[l] = upd
            M = np.where(upd, take, M)
    if M[P] == NEG:
        return None
    C: list[int] = []
    t = P
    true_lat = 0.0
    for l in range(L, 0, -1):
        if keep[l, t]:
            C.append(l)
            true_lat += latency[l]
            t -= tds[l]
    C.reverse()
    return tuple(C), float(M[P]), true_lat


def brute_force(
    L: int,
    table: TableFn,
    T0: float,
    P: int,
) -> tuple[float, list[Segment]] | None:
    """Exponential reference solver for Theorem 3.1 property tests.

    Enumerates every segmentation of ``(0, L]`` and every ``k`` per segment,
    using the same floored-latency feasibility test as :func:`solve_dp`.
    """
    unit = T0 / P
    best: list[tuple[float, list[Segment]]] = [(NEG, [])]

    def rec(pos: int, used: int, imp: float, segs: list[Segment]):
        if pos == L:
            if imp > best[0][0]:
                best[0] = (imp, list(segs))
            return
        for j in range(pos + 1, L + 1):
            opts = table(pos, j)
            for key, (i_val, lat, kept) in opts.items():
                k, mode = split_key(key)
                td = _discretize(lat, unit)
                if used + td <= P:
                    segs.append(Segment(i=pos, j=j, k=k, kept=kept,
                                        quant=mode))
                    rec(j, used + td, imp + i_val, segs)
                    segs.pop()

    rec(0, 0, 0.0, [])
    if best[0][0] == NEG:
        return None
    return best[0]
