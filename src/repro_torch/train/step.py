"""Train-step and serve-step factories.

The JAX package's ``train/step.py`` in PyTorch.  :func:`make_train_step`
returns ``(params, opt_state, batch) → (params, opt_state, metrics)``:
the loss, its gradient over the param tree (``torch.autograd.grad``),
clipping and AdamW (:func:`repro_torch.optim.adamw.adamw_update`, which
writes params and moments in place), optionally accumulating the
gradients of ``microbatches`` slices of the batch.  The step is eager:
on the card every kernel op runs its kernel forward and its plain
version's gradient backward (:mod:`repro_torch.kernels.ops`).
:func:`make_serve_step` returns the one-token decode
``(params, cache, batch) → (logits, cache)``.

:func:`make_compressed_forward` trains a compressed network: its forward
runs the lowered unit graph of an artifact over a params tree
(:func:`repro_torch.runtime.ir.graph_params`), so compression runs once
and fine-tuning continues from the object serving loads.  The JAX
package's gradient shardings (``grad_shardings``) belong to the port's
distribution slice (ROADMAP.md queue 1 item 5).
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import flatten_tree, tree_map, tree_map_with_path


def make_loss_fn(cfg, forward_fn=None):
    """LM loss ``(params, batch) → scalar``; ``forward_fn(params, batch)``
    replaces the stack's forward (a LayerMerge-compressed network)."""
    if forward_fn is None:
        def loss_fn(params, batch):
            return T.lm_loss(cfg, params, batch)
        return loss_fn

    def loss_fn(params, batch):
        logits = T.upcast_for_loss(forward_fn(params, batch))
        return torch.mean(T.token_nll(logits, batch["targets"]))
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)``, the gradients a tree
    shaped like ``params`` (zeros for a leaf the loss does not use)."""
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in flatten_tree(params).items()}
    with torch.enable_grad():
        loss = loss_fn(tree_map_with_path(lambda k, _: leaves[k], params),
                       batch)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True,
            materialize_grads=True)))
    return loss.detach(), tree_map_with_path(lambda k, _: grads[k], params)


def split_batch(batch, microbatches: int) -> list[dict]:
    """``batch`` cut into ``microbatches`` slices of its leading (batch)
    axis; ``mrope_positions`` (3, B, S) is cut on its second.  A value
    with no batch axis, or one that does not divide, is None in every
    slice."""
    out = [{} for _ in range(microbatches)]
    for k, v in batch.items():
        if v is None:
            continue
        axis = 1 if k == "mrope_positions" else 0
        n = v.shape[axis] if v.ndim > axis else 0
        for i, mb in enumerate(out):
            if n == 0 or n % microbatches:
                mb[k] = None
                continue
            b = n // microbatches
            mb[k] = v[i * b:(i + 1) * b] if axis == 0 \
                else v[:, i * b:(i + 1) * b]
    return out


def make_train_step(cfg, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    forward_fn=None, grad_shardings=None):
    """One AdamW step on the LM loss (see the module docstring).  With
    ``microbatches > 1`` the loss and the fp32 gradients are averaged over
    :func:`split_batch`'s slices."""
    if grad_shardings is not None:
        raise NotImplementedError(
            "make_train_step(grad_shardings=...): gradient shardings belong "
            "to the port's distribution slice (ROADMAP.md queue 1 item 5)")
    loss_fn = make_loss_fn(cfg, forward_fn)

    def train_step(params, opt_state, batch):
        if microbatches <= 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=opt_state["step"].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for micro in split_batch(batch, microbatches):
                l, g = value_and_grad(loss_fn, params, micro)
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        params, opt_state, metrics = adamw_update(opt_cfg, grads, opt_state,
                                                  params)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_serve_step(cfg):
    """One-token decode ``(params, cache, batch) → (logits, cache)``; the
    cache's tensors are written in place."""
    def serve_step(params, cache, batch):
        return T.decode_step(cfg, params, cache, batch)
    return serve_step


def make_compressed_forward(graph, *, device="cuda"):
    """``forward_fn(params, batch)`` over a lowered unit graph, on
    ``device`` (the card by default; raises where there is none).

    Pass it to :func:`make_train_step` as ``forward_fn`` with ``params =
    repro_torch.runtime.graph_params(graph)`` (and the matching AdamW
    state) to continue training a compressed model loaded from an
    artifact; :func:`repro_torch.runtime.ir.bind_params` puts the tuned
    params back into a graph that serves or saves."""
    from repro_torch.runtime import execute

    def forward_fn(params, batch):
        return execute(graph, batch, params=params, device=device)
    return forward_fn


def make_prefill_step(cfg):
    """Logits of a whole prompt ``(params, batch) → (B, S, V)``."""
    def prefill_step(params, batch):
        return T.forward(cfg, params, batch)
    return prefill_step
