"""Compression plan datastructures shared by every LayerMerge host.

A *plan* is the output of the DP solver (Algorithm 1 of the paper): the kept
activation-boundary set ``A*``, the kept layer set ``C*`` and the merged-size
``k_i*`` of every segment.  Positions follow the paper's convention:

* layers are ``1..L``; boundary positions are ``0..L``,
* a segment is the half-open interval ``(i, j]`` — it *owns* layers
  ``i+1 .. j``,
* ``A* = {a_1 < ... < a_m} ⊆ [L-1]`` with ``a_0 = 0`` and ``a_{m+1} = L``
  implied,
* ``C* ⊆ [L]`` (always a superset of the irreducible set ``R``).

``k`` is the merged-size coordinate of the lookup tables: merged *kernel
size* on the CNN instantiation, merged *rank* on the transformer
instantiation (see DESIGN.md §2.1).

A plan is pure data: hosts lower it to an executable
:class:`repro_torch.runtime.ir.UnitGraph` via ``host.lower_plan(plan,
params)``, and its JSON form travels inside merged-model artifacts
(:mod:`repro_torch.runtime.artifact`) so a deployment can verify exactly which
``(A*, C*, k*)`` solution it is running.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    """Static description of one compressible layer (paper's (f_l, σ_l))."""

    index: int                  # 1-based position in the chain
    kind: str                   # 'conv' | 'dwconv' | 'ffn' | 'glu_ffn' | 'attn'
                                # | 'moe' | 'rglru' | 'mlstm' | 'slstm' | ...
    growth: int                 # contribution to merged size when KEPT inside a
                                # merged segment: Ker-1 for convs, rank r=d_ff for
                                # linearizable FFNs, 0 for identity.
    value: float                # ℓ1-norm of the parameters (Eq. 3 objective)
    prunable: bool              # can be replaced by the identity (l ∉ R)
    linearizable: bool          # σ_l can be removed (convs: always True —
                                # the conv itself is linear; attention/MoE: False)
    meta: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Segment:
    """One merged segment ``(i, j]`` with its chosen merged size and kept set."""

    i: int
    j: int
    k: int                      # merged size (kernel size / rank)
    kept: tuple[int, ...]       # Ĉ_ijk — kept layer indices within (i, j]
    original: bool = False      # True ⇔ singleton kept exactly as in the source
                                # network (no activation removed)
    quant: str = "none"         # per-unit precision the DP chose for the
                                # merged weights: 'none' | 'int8' | 'w8a8'
                                # | 'fp8' (orthogonal to `original`)

    @property
    def layers(self) -> tuple[int, ...]:
        return tuple(range(self.i + 1, self.j + 1))

    @property
    def pruned(self) -> tuple[int, ...]:
        kept = set(self.kept)
        return tuple(l for l in self.layers if l not in kept)


@dataclasses.dataclass(frozen=True)
class CompressionPlan:
    """Full solution ``(A*, C*, (k_i*))`` as an ordered list of segments."""

    num_layers: int
    segments: tuple[Segment, ...]
    objective: float = 0.0          # Σ I achieved by the DP
    latency: float = 0.0            # Σ T (true, undiscretized) of the plan
    budget: float = 0.0             # T0 handed to the solver
    method: str = "layermerge"      # 'layermerge' | 'depth' | 'layeronly'

    def __post_init__(self):
        # Validate that segments tile (0, L] exactly.
        pos = 0
        for s in self.segments:
            if s.i != pos or s.j <= s.i:
                raise ValueError(f"segments do not tile (0, L]: {self.segments}")
            pos = s.j
        if pos != self.num_layers:
            raise ValueError(
                f"segments end at {pos}, expected L={self.num_layers}")

    # -- paper-notation views ------------------------------------------------
    @property
    def A(self) -> tuple[int, ...]:
        """Kept activation boundaries, ascending (excludes 0 and L)."""
        return tuple(s.j for s in self.segments[:-1])

    @property
    def C(self) -> tuple[int, ...]:
        """Kept layer indices, ascending."""
        out: list[int] = []
        for s in self.segments:
            out.extend(s.kept)
        return tuple(sorted(out))

    @property
    def ks(self) -> tuple[int, ...]:
        return tuple(s.k for s in self.segments)

    def segment_of(self, layer: int) -> Segment:
        for s in self.segments:
            if s.i < layer <= s.j:
                return s
        raise KeyError(layer)

    # -- serialization --------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "num_layers": self.num_layers,
            "objective": self.objective,
            "latency": self.latency,
            "budget": self.budget,
            "method": self.method,
            "segments": [
                {"i": s.i, "j": s.j, "k": s.k, "kept": list(s.kept),
                 "original": s.original,
                 **({"quant": s.quant} if s.quant != "none" else {})}
                for s in self.segments
            ],
        }, indent=2)

    @staticmethod
    def from_json(text: str) -> "CompressionPlan":
        d = json.loads(text)
        return CompressionPlan(
            num_layers=d["num_layers"],
            segments=tuple(
                Segment(i=s["i"], j=s["j"], k=s["k"], kept=tuple(s["kept"]),
                        original=s.get("original", False),
                        quant=s.get("quant", "none"))
                for s in d["segments"]),
            objective=d.get("objective", 0.0),
            latency=d.get("latency", 0.0),
            budget=d.get("budget", 0.0),
            method=d.get("method", "layermerge"),
        )


def identity_plan(num_layers: int, descs: Sequence[LayerDesc]) -> CompressionPlan:
    """The no-op plan: every layer its own original segment."""
    segs = tuple(
        Segment(i=l - 1, j=l, k=d.growth + 1, kept=(l,), original=True)
        for l, d in zip(range(1, num_layers + 1), descs))
    return CompressionPlan(num_layers=num_layers, segments=segs,
                           method="identity")
