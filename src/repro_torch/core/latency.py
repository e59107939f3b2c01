"""Latency oracles that populate the ``T[i,j,k]`` lookup table.

The paper measures every table entry on the deployment device.  Two
oracles:

* :class:`AnalyticOracle` — a roofline model: latency of one fused layer
  is ``overhead + max(flops/peak, bytes/bw)``.  Its constants are
  parameters; the defaults are the H100 SXM's published fp32
  (non-tensor-core) rate and HBM rate (NVIDIA's data sheet, at the card's
  full 700 W power limit).  The parity tests pass the JAX package's
  constants instead and reproduce its analytic latency column bit for bit.
* :class:`WallClockOracle` — times a callable on the card with CUDA
  events (the paper's measured pipeline): ``warmup`` calls, then
  ``iters`` timed calls in ``groups`` contiguous groups; the latency is
  the median of the group means.  It raises where there is no card: it
  never times the CPU.
"""
from __future__ import annotations

import dataclasses
import json
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

    def segment_latency(self, cost: CostBreakdown) -> float:
        return self.op_overhead + max(cost.flops / self.peak_flops,
                                      cost.hbm_bytes / self.hbm_bw)


@dataclasses.dataclass
class WallClockOracle(LatencyOracle):
    """Times callables on the card (paper Appendix C protocol, scaled
    down): median of ``groups`` group means over ``iters`` timed calls,
    each group timed with a pair of CUDA events."""

    warmup: int = 5
    iters: int = 20
    groups: int = 5

    def time_callable(self, fn: Callable[[], torch.Tensor]) -> float:
        """Median of the group means, in seconds."""
        if not torch.cuda.is_available():
            raise RuntimeError("WallClockOracle times the card; "
                               "torch.cuda.is_available() is False")
        for _ in range(self.warmup):
            fn()
        g = max(1, min(self.groups, self.iters))
        base, extra = divmod(self.iters, g)
        events = []
        for gi in range(g):
            n = base + (1 if gi < extra else 0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            events.append((start, end, n))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) / 1e3 / n
                                for s, e, n in events]))

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
                tile_budget: float | None = None) -> CostBreakdown:
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
    """
    from repro_torch.kernels.merged_conv import input_traffic_model

    ho, wo = -(-h // stride), -(-w // stride)
    if depthwise:
        flops = 2.0 * batch * ho * wo * cin * k * k
        wbytes = cin * k * k * dtype_bytes
    else:
        flops = 2.0 * batch * ho * wo * cin * cout * k * k
        wbytes = cin * cout * k * k * dtype_bytes
    in_bytes = float(h * w * cin * dtype_bytes)
    if tile_budget is None:
        if k > 1:
            in_bytes += 2.0 * (h + k - 1) * (w + k - 1) * cin * dtype_bytes
    elif k > 1 or stride > 1:
        traffic = input_traffic_model(
            h + k - 1, w + k - 1, cin, k, k, stride, dtype_bytes,
            groups=cin if depthwise else 1, budget_bytes=tile_budget)
        in_bytes = (max(in_bytes, traffic["dma_bytes"])
                    + traffic["relayout_bytes"])
    abytes = batch * (in_bytes + ho * wo * cout * dtype_bytes)
    return CostBreakdown(flops, wbytes + abytes)
