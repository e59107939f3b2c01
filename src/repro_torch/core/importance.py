"""Importance values ``I[i,j,k]`` — the magnitude proxy.

The paper's Eq. 4 importance fine-tunes each candidate for a few steps and
scores ``exp(ΔPerf)``; that path is not ported yet (ROADMAP queue 1).  The
main path (``python -m repro_torch.compress``) uses the deterministic
magnitude proxy below, as ``python -m repro.compress`` does: ``exp`` of the
negative pruned-ℓ1 fraction.
"""
from __future__ import annotations

import math


def magnitude_importance(value_kept: float, value_total: float,
                         num_pruned: int, temperature: float = 1.0) -> float:
    """``exp(−temperature · pruned ℓ1 fraction)``."""
    if value_total <= 0:
        return 1.0
    drop = (value_total - value_kept) / value_total
    return math.exp(-temperature * drop)
