"""Latency oracles that populate the ``T[i,j,k]`` lookup table.

The paper measures every table entry on the deployment device.  Two
oracles:

* :class:`AnalyticOracle` — a roofline model: latency of one fused layer
  is ``overhead + max(flops/peak, bytes/bw) + link_bytes/link_bw``.  Its
  constants are parameters; the defaults are the H100 SXM's published
  fp32 (non-tensor-core) rate and HBM rate (NVIDIA's data sheet, at the
  card's full 700 W power limit), and no link: on one card an MoE
  block's dispatch crosses none, so its ``ici_bytes`` cost 0 s.  The
  parity tests pass the JAX package's constants instead (its link rate
  included) and reproduce its analytic latency column bit for bit.
* :class:`WallClockOracle` — times a callable on the card (the paper's
  measured pipeline): ``warmup`` eager calls, then ``iters // groups``
  calls captured in one CUDA graph, replayed ``groups`` times, each
  replay timed with CUDA events; the latency is the median of the
  per-call means.  The graph is the counterpart of the JAX package's
  jitted probe: the segment's kernels back to back, without the tens of
  microseconds of eager dispatch per op that would otherwise make a
  segment of many small ops (attention) look slower than its kernels
  and vary between timings.  It raises where there is no card: it never
  times the CPU.  It holds each probe signature's timing, so the
  original network's latency and the tables built with the same oracle
  read one measurement of each shape.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Callable

import numpy as np
import torch

#: H100 SXM, NVIDIA data sheet (dense, 700 W): fp32 outside the tensor
#: cores, and HBM3 bandwidth.
H100_FP32_FLOPS = 67e12
H100_HBM_BW = 3.35e12


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    """Static cost of one (possibly merged) layer on one device."""

    flops: float
    hbm_bytes: float
    #: Bytes that cross a link between devices (an MoE block's token
    #: dispatch, as the JAX package prices it).
    ici_bytes: float = 0.0

    def __add__(self, other: "CostBreakdown") -> "CostBreakdown":
        return CostBreakdown(self.flops + other.flops,
                             self.hbm_bytes + other.hbm_bytes,
                             self.ici_bytes + other.ici_bytes)

    def __mul__(self, scale: float) -> "CostBreakdown":
        return CostBreakdown(self.flops * scale, self.hbm_bytes * scale,
                             self.ici_bytes * scale)

    __rmul__ = __mul__


class LatencyOracle:
    def segment_latency(self, cost: CostBreakdown) -> float:  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass
class AnalyticOracle(LatencyOracle):
    peak_flops: float = H100_FP32_FLOPS
    hbm_bw: float = H100_HBM_BW
    # Fixed cost per fused layer: an assumed order of one kernel launch
    # plus eager dispatch, not a measurement.
    op_overhead: float = 5.0e-6
    #: Bytes/s of the link ``ici_bytes`` cross; None: no link (one
    #: device), the term costs 0 s.
    ici_bw: float | None = None

    def segment_latency(self, cost: CostBreakdown) -> float:
        network = 0.0 if self.ici_bw is None else cost.ici_bytes / self.ici_bw
        return self.op_overhead + max(cost.flops / self.peak_flops,
                                      cost.hbm_bytes / self.hbm_bw) + network


@dataclasses.dataclass
class WallClockOracle(LatencyOracle):
    """Times callables on the card (paper Appendix C protocol, scaled
    down): ``iters // groups`` calls captured in one CUDA graph and
    replayed ``groups`` times, each replay timed with a pair of CUDA
    events; the median per-call time of the replays.

    It holds what it learned of each probe signature (:meth:`recall`,
    :meth:`remember`): the probe engine times a signature once per oracle,
    so ``T_orig`` and every table entry of one shape read one timing —
    two timings of one shape differ by run-to-run noise, which the DP
    would read as a saving or a loss.  A resumed build's journal and a
    cache hit seed it with their recorded seconds before anything is
    timed."""

    warmup: int = 5
    iters: int = 20
    groups: int = 5

    def __post_init__(self):
        # Not fields: the oracle's identity (its cache token) is its
        # protocol, not what it has timed.
        #: Seconds per probe signature, timed or seeded.
        self.measured: dict = {}
        #: Provenance flag per probe signature held (``measured``,
        #: ``retimed`` or ``quarantined``: no seconds).
        self.flags: dict = {}
        #: Signatures this oracle timed on the card (not seeded).
        self.num_timed = 0

    def recall(self, sig):
        """``(seconds or None, flag)`` held for ``sig``, else None."""
        if sig not in self.flags:
            return None
        return self.measured.get(sig), self.flags[sig]

    def remember(self, sig, seconds: float | None, flag: str, *,
                 timed: bool) -> None:
        """Hold ``sig``'s seconds (None: quarantined) and provenance flag;
        ``timed`` when the seconds were measured now, not replayed."""
        self.flags[sig] = flag
        if seconds is None:
            self.measured.pop(sig, None)
        else:
            self.measured[sig] = seconds
        self.num_timed += bool(timed)

    def time_callable_stats(self, fn: Callable[[], torch.Tensor], *,
                            warmup: int | None = None
                            ) -> tuple[float, float]:
        """``(median per-call seconds, relative spread)`` over the graph
        replays; ``warmup`` overrides the configured eager warm-up count
        (the probe engine passes one less for a probe it already ran).

        The spread, ``(max − min) / median`` over the replays' per-call
        means, is the probe engine's outlier signal (the JAX package's
        group-mean spread): a replay disturbed by something else on the
        card leaves the median usable but the spread large."""
        if not torch.cuda.is_available():
            raise RuntimeError("WallClockOracle times the card; "
                               "torch.cuda.is_available() is False")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):        # warm up off the capture stream
            for _ in range(self.warmup if warmup is None else warmup):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        g = max(1, min(self.groups, self.iters))
        n = max(1, self.iters // g)
        graph = torch.cuda.CUDAGraph()
        with warnings.catch_warnings():
            # A probe of a segment that keeps nothing launches nothing.
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            with torch.cuda.graph(graph):
                for _ in range(n):
                    fn()
        graph.replay()
        events = []
        for _ in range(g):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        means = [s.elapsed_time(e) / 1e3 / n for s, e in events]
        med = float(np.median(means))
        return med, float((max(means) - min(means)) / max(med, 1e-12))

    def time_callable(self, fn: Callable[[], torch.Tensor]) -> float:
        """Median per-call device time over the graph replays, in
        seconds."""
        return self.time_callable_stats(fn)[0]

    def segment_latency(self, cost: CostBreakdown) -> float:
        raise TypeError(
            "WallClockOracle times callables; use time_callable via the host")


def oracle_token(oracle) -> str:
    """JSON identity of an oracle: class name and dataclass fields."""
    cfg = dataclasses.asdict(oracle) if dataclasses.is_dataclass(oracle) \
        else {}
    return json.dumps({"cls": type(oracle).__name__, "cfg": cfg},
                      sort_keys=True)


# ---------------------------------------------------------------------------
# Cost helpers shared by the hosts
# ---------------------------------------------------------------------------

def conv2d_cost(h: int, w: int, cin: int, cout: int, k: int, stride: int = 1,
                depthwise: bool = False, dtype_bytes: int = 4,
                batch: int = 1,
                tile_budget: float | None = None,
                w_bytes: int | None = None,
                act_bytes: int | None = None) -> CostBreakdown:
    """Analytic cost of one (possibly merged) conv layer: the FLOPs of the
    merged conv and its bytes, the weight once plus per image:

    * ``tile_budget`` None (the default) — what the port moves on the
      card: for ``k > 1`` the executor's spatial pad (read the image,
      write the padded copy) and the kernel's one read of the padded
      copy, else one read of the image; then the output written once.
      The CUDA kernels read the strided NHWC input in place, so no
      relayout is priced.
    * a ``tile_budget`` — the JAX package's tiled traffic model under that
      tile working set (:func:`repro_torch.kernels.merged_conv.
      input_traffic_model`: halo re-reads at tile seams and the
      phase-major relayout of a strided segment).  The parity tests pass
      the JAX package's budget and reproduce its costs bit for bit.

    ``w_bytes`` / ``act_bytes`` split the byte widths for quantized units
    (int8 or fp8 weights: ``w_bytes=1``; w8a8 also ``act_bytes=1``); both
    default to ``dtype_bytes``, which leaves every fp cost bit-identical.
    The weight term is priced at ``w_bytes``.  Under the default pricing
    the input and pad-copy terms are priced at ``act_bytes`` and the
    output at ``dtype_bytes``, since the quantized kernels write fp32;
    under a ``tile_budget`` every activation term is priced at
    ``act_bytes``, as the JAX package prices it.
    """
    from repro_torch.kernels.merged_conv import input_traffic_model

    wb = dtype_bytes if w_bytes is None else w_bytes
    ab = dtype_bytes if act_bytes is None else act_bytes
    ho, wo = -(-h // stride), -(-w // stride)
    if depthwise:
        flops = 2.0 * batch * ho * wo * cin * k * k
        wbytes = cin * k * k * wb
    else:
        flops = 2.0 * batch * ho * wo * cin * cout * k * k
        wbytes = cin * cout * k * k * wb
    in_bytes = float(h * w * cin * ab)
    out_b = ab
    if tile_budget is None:
        out_b = dtype_bytes
        if k > 1:
            in_bytes += 2.0 * (h + k - 1) * (w + k - 1) * cin * ab
    elif k > 1 or stride > 1:
        traffic = input_traffic_model(
            h + k - 1, w + k - 1, cin, k, k, stride, ab,
            groups=cin if depthwise else 1, budget_bytes=tile_budget)
        in_bytes = (max(in_bytes, traffic["dma_bytes"])
                    + traffic["relayout_bytes"])
    abytes = batch * (in_bytes + ho * wo * cout * out_b)
    return CostBreakdown(flops, wbytes + abytes)


def matmul_cost(m: int, kdim: int, n: int, dtype_bytes: int = 2,
                w_bytes: int | None = None,
                act_bytes: int | None = None) -> CostBreakdown:
    """``(m, kdim) @ (kdim, n)``: its FLOPs, and each operand read and the
    output written once.  The ``(kdim, n)`` operand is the weight
    (``w_bytes``), the ``(m, kdim)`` input and the ``(m, n)`` output are
    activations (``act_bytes``); both default to ``dtype_bytes``."""
    wb = dtype_bytes if w_bytes is None else w_bytes
    ab = dtype_bytes if act_bytes is None else act_bytes
    flops = 2.0 * m * kdim * n
    bytes_ = m * kdim * ab + kdim * n * wb + m * n * ab
    return CostBreakdown(flops, bytes_)


def rank_ffn_cost(tokens: int, d: int, rank: int,
                  dtype_bytes: int = 2, w_bytes: int | None = None,
                  act_bytes: int | None = None) -> CostBreakdown:
    """Merged rank-``r`` residual layer: ``x + (x·U)·V`` (two thin GEMMs,
    as the JAX package prices it: ``P`` is counted as written and read,
    as the ``merged_ffn`` kernel does through its (M, R) fp32 workspace)."""
    r = min(rank, d)
    return (matmul_cost(tokens, d, r, dtype_bytes, w_bytes, act_bytes)
            + matmul_cost(tokens, r, d, dtype_bytes, w_bytes, act_bytes))
