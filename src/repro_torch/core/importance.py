"""Importance values ``I[i,j,k]`` (Eq. 4) — fine-tune-and-measure.

The paper defines the importance of a merged layer as::

    I[i,j,k] = exp( Perf(net with segment (i,j] replaced, few-step FT)
                    − Perf(pre-trained net) )

with performance = accuracy (classification) or −loss (divided by the
pre-trained loss with ``normalize_by_base``, the paper's DDPM trick).
The ``exp`` keeps importances positive.  The fine-tune is a few steps of
Adam on a few batches; :func:`distill_loss` is the data-free proxy
(match the pre-trained network's outputs), as in the JAX package.

Parameters are the hosts' nested dicts / lists of tensors and
``apply_fn(params, batch)`` is functional over them.  Every leaf is
tuned — BN statistics included, as the JAX package's ``jax.tree.map``
over the whole pytree does.  The scalar path takes gradients with
``torch.autograd.grad`` on fresh leaves (so it runs through the kernel
ops' autograd on the card); the batched path is ``torch.func.vmap`` of
``torch.func.grad`` over a stacked probe axis.  Both apply the same Adam
arithmetic in the same order.  One card: the JAX package's ``pmap``
branch and its jit caches have no counterpart.

:func:`magnitude_importance` is the cheap deterministic proxy that
``python -m repro_torch.compress`` uses.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch
from torch.utils import _pytree as pytree

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class ImportanceSpec:
    """How to fine-tune and score a candidate replaced network."""

    loss_fn: Callable          # (apply_fn, params, batch) -> scalar loss
    perf_fn: Callable          # (apply_fn, params, batches) -> float (higher=better)
    train_batches: Sequence    # few batches for the short fine-tune
    eval_batches: Sequence
    steps: int = 8
    lr: float = 1e-3
    normalize_by_base: bool = False   # DDPM trick: divide by base loss
    cache_token: str | None = None    # stable workload name for the table
                                      # cache (closures are not
                                      # content-addressable)


def _lr_t(spec: ImportanceSpec, t: int) -> float:
    return spec.lr * math.sqrt(1 - B2 ** t) / (1 - B1 ** t)


def _adam_update(p, m, v, g, lr_t):
    """One Adam step of the leaf lists ``p``, ``m``, ``v`` with gradients
    ``g``, elementwise in the JAX package's order::

        m = b1·m + (1 − b1)·g;  v = b2·v + ((1 − b2)·g)·g
        p = p − (lr_t·m) / (√v + eps)

    as multi-tensor ops (a few launches for all leaves, not a dozen per
    leaf: the same roundings).  Returns the new ``(p, m, v)`` lists."""
    m = torch._foreach_add(torch._foreach_mul(m, B1),
                           torch._foreach_mul(g, 1 - B1))
    v = torch._foreach_add(torch._foreach_mul(v, B2), torch._foreach_mul(
        torch._foreach_mul(g, 1 - B2), g))
    den = torch._foreach_add(torch._foreach_sqrt(v), EPS)
    p = torch._foreach_sub(p, torch._foreach_div(
        torch._foreach_mul(m, lr_t), den))
    return p, m, v


def _adam_finetune(apply_fn, params, spec: ImportanceSpec):
    """Minimal Adam used only for the few-step Eq. 4 fine-tune; returns a
    new parameter tree (``params`` is not modified)."""
    leaves, treedef = pytree.tree_flatten(params)
    leaves = [x.detach() for x in leaves]
    m = [torch.zeros_like(x) for x in leaves]
    v = [torch.zeros_like(x) for x in leaves]
    for step in range(spec.steps):
        batch = spec.train_batches[step % len(spec.train_batches)]
        live = [x.requires_grad_() for x in leaves]
        loss = spec.loss_fn(apply_fn, pytree.tree_unflatten(live, treedef),
                            batch)
        g = torch.autograd.grad(loss, live, allow_unused=True)
        g = [torch.zeros_like(x) if gg is None else gg   # unused: JAX's 0
             for x, gg in zip(live, g)]
        with torch.no_grad():
            leaves, m, v = _adam_update([x.detach() for x in live], m, v, g,
                                        _lr_t(spec, step + 1))
    return pytree.tree_unflatten(leaves, treedef)


def adam_finetune_batched(apply_fn, stacked_params, spec: ImportanceSpec,
                          grad_mask=None):
    """Vmapped few-step Adam over a stacked probe axis (probe engine path).

    ``stacked_params`` is one tree whose leaves carry a leading probe axis;
    ``apply_fn`` is shared by every lane (the host guarantees the
    candidates are apply-compatible).  ``grad_mask`` (same structure,
    stacked 0/1 scalars) freezes leaves that must stay exactly at their
    candidate value — the Dirac kernels standing in for pruned convs,
    whose update would turn "no layer" into a free extra layer.  One
    fine-tune step for all lanes is one vmapped grad and one update.
    """
    leaves, treedef = pytree.tree_flatten(stacked_params)
    leaves = [x.detach() for x in leaves]
    if grad_mask is None:
        masks = [torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
                 for x in leaves]
    else:
        masks = pytree.tree_leaves(grad_mask)
    masks = [mk.reshape((-1,) + (1,) * (x.ndim - 1))
             for mk, x in zip(masks, leaves)]

    def loss(p, batch):
        return spec.loss_fn(apply_fn, p, batch)
    grad_fn = torch.func.vmap(torch.func.grad(loss), in_dims=(0, None))
    m = [torch.zeros_like(x) for x in leaves]
    v = [torch.zeros_like(x) for x in leaves]
    for s in range(spec.steps):
        batch = spec.train_batches[s % len(spec.train_batches)]
        g = pytree.tree_leaves(grad_fn(
            pytree.tree_unflatten(leaves, treedef), batch))
        with torch.no_grad():
            leaves, m, v = _adam_update(
                leaves, m, v, [gg * mk for gg, mk in zip(g, masks)],
                _lr_t(spec, s + 1))
    return pytree.tree_unflatten(leaves, treedef)


def perf_to_importance(perf: float, base_perf: float,
                       spec: ImportanceSpec) -> float:
    """Eq. 4 scoring shared by the scalar and batched probe paths."""
    delta = perf - base_perf
    if spec.normalize_by_base and base_perf != 0:
        delta = delta / abs(base_perf)
    # clamp for numerical sanity (perf deltas are small by construction);
    # the exp in fp32, as the JAX package's jnp.exp of a Python float
    return float(torch.exp(torch.tensor(min(max(delta, -30.0), 30.0),
                                        dtype=torch.float32)))


def measure_importance(apply_fn, params, spec: ImportanceSpec,
                       base_perf: float) -> float:
    """One table entry: fine-tune the replaced net, return exp(ΔPerf)."""
    tuned = _adam_finetune(apply_fn, params, spec)
    perf = spec.perf_fn(apply_fn, tuned, spec.eval_batches)
    return perf_to_importance(perf, base_perf, spec)


def magnitude_importance(value_kept: float, value_total: float,
                         num_pruned: int, temperature: float = 1.0) -> float:
    """``exp(−temperature · pruned ℓ1 fraction)``: the cheap deterministic
    proxy (beyond the paper, for fast sweeps)."""
    if value_total <= 0:
        return 1.0
    drop = (value_total - value_kept) / value_total
    return math.exp(-temperature * drop)


# -- ready-made loss/perf functions -----------------------------------------

def xent_loss(apply_fn, params, batch):
    x, y = batch
    logp = torch.log_softmax(apply_fn(params, x), dim=-1)
    return -torch.mean(torch.take_along_dim(logp, y[:, None].long(), dim=1))


def accuracy_perf(apply_fn, params, batches):
    correct = total = 0
    with torch.no_grad():
        for x, y in batches:
            correct += float(torch.sum(
                torch.argmax(apply_fn(params, x), dim=-1) == y))
            total += y.shape[0]
    return correct / max(total, 1)


def neg_loss_perf(loss_fn):
    def perf(apply_fn, params, batches):
        tot = 0.0
        with torch.no_grad():
            for b in batches:
                tot += float(loss_fn(apply_fn, params, b))
        return -tot / max(len(batches), 1)
    return perf


def distill_loss(teacher_fn):
    """Self-distillation: match the pre-trained network's outputs (data-free)."""
    def loss(apply_fn, params, batch):
        x = batch[0] if isinstance(batch, tuple) else batch
        target = teacher_fn(x)
        out = apply_fn(params, x)
        return torch.mean((out - target) ** 2)
    return loss
