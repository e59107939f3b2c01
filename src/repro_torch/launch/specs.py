"""Input specs of every (arch × shape) dry-run cell, allocating nothing.

The port's copy of the JAX package's ``launch/specs.py``, name for name.
Where JAX gives ``ShapeDtypeStruct`` records, these are tensors on the
``meta`` device (a shape and a dtype, no memory), which the port's own
functions run on as they run on a card (:mod:`repro_torch.launch.dryrun`).
For ``embeddings``-frontend archs (musicgen, qwen2-vl) the modality
frontend is a stub, as in the reference: the spec feeds precomputed
frame or patch embeddings.

The decode cache is the port's: one state per layer
(:func:`repro_torch.models.transformer.init_cache`), where the reference
stacks each layer group's states.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer as T


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, *, with_targets: bool):
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "decode":
        S = 1
    specs = {"positions": _spec((B, S), torch.int32)}
    if cfg.frontend == "tokens":
        specs["tokens"] = _spec((B, S), torch.int32)
    else:
        specs["embeds"] = _spec((B, S, cfg.d_model), getattr(torch,
                                                             cfg.dtype))
    if cfg.rope_kind == "mrope":
        specs["mrope_positions"] = _spec((3, B, S), torch.int32)
    if with_targets:
        specs["targets"] = _spec((B, S), torch.int32)
    if shape.mode == "decode":
        specs.pop("positions")      # decode derives positions from the cache
    return specs


def batch_axes(cfg: ArchConfig, shape: ShapeConfig, *, with_targets: bool):
    """Logical axes matching :func:`batch_specs`."""
    ax = {"positions": ("batch", "seq")}
    if cfg.frontend == "tokens":
        ax["tokens"] = ("batch", "seq")
    else:
        ax["embeds"] = ("batch", "seq", None)
    if cfg.rope_kind == "mrope":
        ax["mrope_positions"] = (None, "batch", "seq")
    if with_targets:
        ax["targets"] = ("batch", "seq")
    if shape.mode == "decode":
        ax.pop("positions")
    return ax


def cache_specs(cfg: ArchConfig, shape: ShapeConfig):
    """The decode cache of the whole batch (under a mesh's rules, this
    rank's block of it), one state per layer."""
    return T.init_cache(cfg, shape.global_batch, shape.seq_len,
                        device="meta")


def param_specs(cfg: ArchConfig):
    """(abstract params, logical axes) without allocating anything."""
    return T.init_model(cfg, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig):
    """The full spec dict the dry run runs against."""
    if shape.mode == "train":
        return {"batch": batch_specs(cfg, shape, with_targets=True)}
    if shape.mode == "prefill":
        return {"batch": batch_specs(cfg, shape, with_targets=False)}
    if shape.mode == "decode":
        return {"batch": batch_specs(cfg, shape, with_targets=False),
                "cache": cache_specs(cfg, shape)}
    raise ValueError(shape.mode)
