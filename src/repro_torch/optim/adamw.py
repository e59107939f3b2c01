"""AdamW, the cosine schedule and global-norm clipping over param trees.

The JAX package's ``optim/adamw.py`` in PyTorch, on plain tensor trees
(:mod:`repro_torch.tree`), not ``torch.optim.AdamW``: that one decays the
weights before the moment step, and this is the reference's order —
clip by the global norm, update the fp32 moments, bias-correct them,
then apply the step and the decoupled weight decay to an fp32 copy of
the param and cast it back.  The moments are fp32 whatever the param
dtype; ``step`` is an int32 scalar on the params' device.

The update is written in place: the params and the moments of the trees
passed in are overwritten and the same tensors come back (PyTorch's
optimizer idiom).  A functional update would hold two copies of params
and moments at once, 33 GB more for RecurrentGemma-2B in fp32.  Callers
that need the old values copy them first (:func:`repro_torch.train.loop.
train_loop` copies the caller's params).  Nothing reads the host, so a
step can later be captured in a CUDA graph.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import flatten_tree, tree_leaves, tree_map, \
    tree_map_with_path


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_lr(cfg: AdamWConfig, step):
    """Linear warmup to ``cfg.lr``, then a cosine down to ``min_lr_ratio``
    of it at ``total_steps``: an fp32 scalar tensor (on ``step``'s device
    when it is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params, shardings=None):
    """Zero fp32 moments ``mu``, ``nu`` beside each param, and ``step`` 0.

    Under a mesh a param is this rank's block and its moments are the
    same block, carrying its placement; with ``shardings`` (the
    ``grad_shardings`` of :func:`repro_torch.train.step.make_train_step`,
    a tree of placements like the params') each moment is this rank's
    block of that placement instead (ZeRO)."""
    from repro_torch.sharding.rules import sharding_of, with_sharding

    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    if isinstance(shardings, dict) and set(shardings) == {"mu", "nu",
                                                          "step"}:
        shardings = shardings["mu"]
    places = flatten_tree(shardings) if shardings is not None else {}

    def zeros(key, p):
        place = places.get(key, sharding_of(p))
        shape = p.shape
        if key in places:
            own = sharding_of(p)
            whole = own.shape if own is not None and own.shape else p.shape
            shape = place.local_shape(whole)
        return with_sharding(torch.zeros(shape, dtype=torch.float32,
                                         device=p.device), place)
    return {"mu": tree_map_with_path(zeros, params),
            "nu": tree_map_with_path(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_axes(param_axes):
    """Optimizer-state logical axes mirror the parameter axes."""
    return {"mu": param_axes, "nu": param_axes, "step": ()}


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def _clip_scale(norm, max_norm: float):
    """min(1, max_norm / max(norm, 1e-12)), a true division (PyTorch's
    ``float / tensor`` multiplies by the reciprocal)."""
    num = torch.full_like(norm, max_norm)
    return torch.clamp(num / torch.clamp(norm, min=1e-12), max=1.0)


def sharded_global_norm(grads: dict, split_axes: dict, mesh):
    """The global norm of gradient blocks: each leaf's fp32 sum of
    squares summed over the mesh axes its block is split on
    (``split_axes[key]``; a leaf whole over an axis counts once), then
    over the leaves."""
    from repro_torch.sharding.collectives import all_reduce

    groups: dict = {}
    for k, g in grads.items():
        sq = torch.sum(torch.square(g.to(torch.float32)))
        key = split_axes[k]
        groups[key] = sq if key not in groups else groups[key] + sq
    total = None
    for axes, sq in groups.items():
        if axes:
            sq = all_reduce(sq.reshape(1).clone(), mesh,
                            tuple(a for a in mesh.axis_names if a in axes)
                            ).reshape(())
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm):
    """``(grads scaled to at most max_norm in global norm, in fp32, the
    norm before clipping)``."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state, params, *, gnorm=None):
    """One AdamW step, in place: returns ``(params, state, metrics)``, the
    params and moments being the tensors passed in, overwritten.  Each
    leaf's clipped fp32 gradient is made (and freed) in turn, the same
    arithmetic as :func:`clip_by_global_norm`.  ``gnorm`` (optional) is
    the norm to clip by, where the grads are blocks of a sharded tree
    (:func:`sharded_global_norm`)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    t = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    flat_g = flatten_tree(grads)
    flat_m = flatten_tree(state["mu"])
    flat_v = flatten_tree(state["nu"])

    def upd(key, p):
        g = flat_g[key].to(torch.float32) * scale
        m, v = flat_m[key], flat_v[key]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mh = m / bc1
        vh = v / bc2
        p32 = p.to(torch.float32)
        p.copy_(p32 - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                            + cfg.weight_decay * p32))
    tree_map_with_path(upd, params)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, \
        metrics
