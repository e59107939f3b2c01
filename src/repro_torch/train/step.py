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

Under a mesh (:func:`repro_torch.sharding.rules.use_rules`, the params
this rank's blocks as :func:`repro_torch.sharding.rules.put` places
them) the same step is the reference's SPMD step, with the collectives
XLA would insert written out:

* each rank takes the loss over its data block
  (:func:`repro_torch.models.transformer.lm_loss`; every rank reports the
  global loss), and the collectives of the forward carry their gradients
  (:mod:`repro_torch.sharding.collectives`);
* the gradients are summed over the data axes: a weight FSDP split over
  them was reduce-scattered by its gather's backward, every other leaf is
  all-reduced (one bucket per set of axes and dtype);
* with ``grad_shardings`` (the optimizer-state placements, a tree of
  :class:`~repro_torch.sharding.rules.Placement` like the params' or
  ``{"mu", "nu", "step"}`` of them) a leaf whose placement splits further
  than its param's is reduce-scattered onto it instead, AdamW updates
  that block of the param (its moments are that block's shape:
  :func:`repro_torch.optim.adamw.init_opt_state` with ``shardings=``),
  and the block is gathered back into the param (ZeRO);
* the clip norm sums each leaf's squares over exactly the axes its
  gradient is split on
  (:func:`repro_torch.optim.adamw.sharded_global_norm`), so it is the
  single device's norm.

:func:`make_compressed_forward` trains a compressed network: its forward
runs the lowered unit graph of an artifact over a params tree
(:func:`repro_torch.runtime.ir.graph_params`), so compression runs once
and fine-tuning continues from the object serving loads.  Under a mesh
it trains sharded as the stack does (the graph's params placed by
:func:`repro_torch.runtime.executor.graph_shardings`): its unit loops
carry the same conjugate collectives, and each rank takes the loss of
its own rows (:func:`make_loss_fn`); so does the plan-aware forward of
:func:`repro_torch.models.transformer_host.forward_compressed_spec`.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     sharded_global_norm)
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import (Placement, _axes_of, active_rules,
                                        data_axes, sharding_of,
                                        with_sharding)
from repro_torch.tree import flatten_tree, tree_map, tree_map_with_path


def make_loss_fn(cfg, forward_fn=None):
    """LM loss ``(params, batch) → scalar``; ``forward_fn(params, batch)``
    replaces the stack's forward (a LayerMerge-compressed network): the
    mean NLL over every token, as the reference takes it.  Under a mesh a
    ``forward_fn`` with a ``local`` attribute (``local(params, batch)`` →
    :func:`repro_torch.models.transformer.forward_local`'s triple:
    :func:`make_compressed_forward`, :func:`repro_torch.models.
    transformer_host.spec_forward`) gives each rank's share of the loss
    from its own rows and vocab slice, as the stack's loss does; any
    other ``forward_fn`` returns the gathered logits, whose loss every
    rank takes whole (its gathers' backward passes each rank the
    gradient of its own block)."""
    if forward_fn is None:
        def loss_fn(params, batch):
            return T.lm_loss(cfg, params, batch)
        return loss_fn
    local = getattr(forward_fn, "local", None)

    def loss_fn(params, batch):
        if local is not None and active_rules() is not None:
            return T.local_loss(cfg, *local(params, batch), use_mask=False)
        logits = T.upcast_for_loss(forward_fn(params, batch))
        return torch.mean(T.token_nll(logits, batch["targets"]))
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)``, the gradients a tree
    shaped like ``params`` (zeros for a leaf the loss does not use)."""
    leaves = {k: with_sharding(v.detach().requires_grad_(True),
                               sharding_of(v))
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
    slice.  A rank's block of a batch (its tensors carry a placement
    split on the batch axis) is cut into blocks of the microbatches."""
    out = [{} for _ in range(microbatches)]
    for k, v in batch.items():
        if v is None:
            continue
        axis = 1 if k == "mrope_positions" else 0
        n = v.shape[axis] if v.ndim > axis else 0
        place = sharding_of(v)
        for i, mb in enumerate(out):
            if n == 0 or n % microbatches:
                mb[k] = None
                continue
            b = n // microbatches
            mb[k] = v[i * b:(i + 1) * b] if axis == 0 \
                else v[:, i * b:(i + 1) * b]
            if place is not None and place.is_split(0) and axis == 0:
                with_sharding(mb[k], Placement(
                    place.mesh, place.spec,
                    (place.shape[0] // microbatches, *place.shape[1:])))
    return out


def make_train_step(cfg, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    forward_fn=None, grad_shardings=None):
    """One AdamW step on the LM loss (see the module docstring).  With
    ``microbatches > 1`` the loss and the fp32 gradients are averaged over
    :func:`split_batch`'s slices.  Under the ambient rules the step is
    the sharded one; ``grad_shardings`` needs them."""
    loss_fn = make_loss_fn(cfg, forward_fn)

    def train_step(params, opt_state, batch):
        rules = active_rules()
        if rules is None and grad_shardings is not None:
            raise ValueError("make_train_step(grad_shardings=...) runs under "
                             "use_rules(rules) with a mesh")
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
        if rules is None:
            params, opt_state, metrics = adamw_update(opt_cfg, grads,
                                                      opt_state, params)
        else:
            opt_state, metrics = sharded_update(
                opt_cfg, grads, opt_state, params, rules, grad_shardings)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


class _Leaf:
    """How one leaf's gradient is reduced and updated under a mesh: summed
    over the data axes its param is not split on — ``scatter`` ((dim,
    axes)) reduce-scattered onto the grad sharding's further split, the
    rest (``sum_axes``) all-reduced."""

    def __init__(self, param, grad_place, daxes):
        pp = sharding_of(param)
        own = pp.spec if pp is not None else ()
        target = grad_place.spec if grad_place is not None else own
        used = {a for part in own for a in _axes_of(part)}
        todo = [a for a in daxes if a not in used]
        self.scatter = []
        for d in range(max(len(own), len(target))):
            a_own = _axes_of(own[d] if d < len(own) else None)
            a_tgt = _axes_of(target[d] if d < len(target) else None)
            extra = a_tgt[len(a_own):]
            if a_tgt[:len(a_own)] != a_own or any(a not in todo
                                                  for a in extra):
                raise ValueError(f"grad sharding {target} does not split "
                                 f"the param's {own} further over data "
                                 "axes it sums")
            if extra:
                self.scatter.append((d, extra))
                todo = [a for a in todo if a not in extra]
        self.sum_axes = tuple(todo)
        self.split_axes = frozenset(a for part in target
                                    for a in _axes_of(part))

    def block(self, t, mesh):
        """This rank's block of ``t`` (a view) along the further splits."""
        for d, axes in self.scatter:
            start, size = C.block(t.shape[d], mesh, axes)
            t = t.narrow(d, start, size)
        return t


def _sum_buckets(grads: dict, plans: dict, mesh) -> dict:
    """Every gradient summed over its leaf's ``sum_axes``: one all-reduce
    per (axes, dtype) bucket of the leaves flattened end to end."""
    buckets: dict = {}
    for k, g in grads.items():
        if plans[k].sum_axes:
            buckets.setdefault((plans[k].sum_axes, g.dtype), []).append(k)
    out = dict(grads)
    for (axes, _), keys in buckets.items():
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        flat = C.all_reduce(flat, mesh, axes)
        o = 0
        for k in keys:
            n = grads[k].numel()
            out[k] = flat[o:o + n].view(grads[k].shape)
            o += n
    return out


@torch.no_grad()
def sharded_update(opt_cfg: AdamWConfig, grads, opt_state, params, rules,
                   grad_shardings=None):
    """The mesh half of the train step (see the module docstring): reduce
    the gradients over the data axes (onto ``grad_shardings``' blocks
    where given), clip by the single device's global norm, update each
    param's block in place and gather it back.  Returns ``(opt_state,
    metrics)``; ``params`` are written in place."""
    mesh = rules.mesh
    daxes = data_axes(rules)
    if isinstance(grad_shardings, dict) and set(grad_shardings) == {
            "mu", "nu", "step"}:
        grad_shardings = grad_shardings["mu"]
    flat_p = flatten_tree(params)
    flat_gs = flatten_tree(grad_shardings) if grad_shardings is not None \
        else {}
    plans = {k: _Leaf(p, flat_gs.get(k), daxes) for k, p in flat_p.items()}
    flat_g = _sum_buckets(flatten_tree(grads), plans, mesh)
    for k, plan in plans.items():
        for d, axes in plan.scatter:
            flat_g[k] = C.reduce_scatter(flat_g[k], mesh, axes, d)
    gnorm = sharded_global_norm(
        flat_g, {k: plan.split_axes for k, plan in plans.items()}, mesh)
    views = {k: plans[k].block(p, mesh) for k, p in flat_p.items()}
    mu = flatten_tree(opt_state["mu"])
    for k, v in views.items():
        if tuple(mu[k].shape) != tuple(v.shape):
            raise ValueError(f"moment {k} is {tuple(mu[k].shape)}, its "
                             f"param's block {tuple(v.shape)}: build the "
                             "state with init_opt_state(params, "
                             "shardings=grad_shardings)")
    _, opt_state, metrics = adamw_update(
        opt_cfg, tree_map_with_path(lambda k, _: flat_g[k], params),
        opt_state, tree_map_with_path(lambda k, _: views[k], params),
        gnorm=gnorm)
    for k, plan in plans.items():
        if plan.scatter:
            whole = views[k]
            for d, axes in plan.scatter:
                whole = C.all_gather(whole, mesh, axes, dim=d)
            flat_p[k].copy_(whole)
    return opt_state, metrics


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
    from repro_torch.runtime import executor

    def forward_fn(params, batch):
        return executor.execute(graph, batch, params=params, device=device)

    def local(params, batch):
        return executor.execute_local(graph, batch, params=params,
                                      device=device)
    forward_fn.local = local
    return forward_fn


def make_prefill_step(cfg):
    """Logits of a whole prompt ``(params, batch) → (B, S, V)``."""
    def prefill_step(params, batch):
        return T.forward(cfg, params, batch)
    return prefill_step
