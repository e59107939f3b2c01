"""Mixture-of-Experts FFN — top-k routing with capacity-based dispatch.

The JAX package's ``models/moe.py`` in PyTorch, with its parameter names,
layouts and logical axes: ``router (D, E)``, ``w_gate``/``w_up (E, D,
F)``, ``w_down (E, F, D)``.  Capacity semantics are GShard's: per-expert
buffers of ``C = ceil(N·k/E · capacity_factor)`` slots, first come first
served in token order; an overflowing (token, slot) pair is dropped (its
gate weight is zeroed, the residual path carries the token).  So a
token's output depends on the other tokens of its batch, as in the JAX
package.

Dispatch is a fixed-size ``(E, C, D)`` buffer filled by ``index_put_``
(accumulating: each filled slot receives one token's row plus exact zeros
from dropped pairs, so the sum is the same in any order), and the combine
is a gather.  ``C`` is computed in Python from shapes, the ranking
(:func:`capacity_positions`) is a stable argsort on the device, and
nothing reads the host: a decode step through this block can be captured
in a CUDA graph.  The expert products are plain batched products
(``torch.einsum``); they are no Pallas kernel in the JAX package either.

Under a data-only mesh each rank routes its own rows of the batch, one
group a rank: the JAX package's grouped dispatch (a group per data
shard).  The expert-parallel path (``moe_ffn_sharded``, the branch of
:func:`moe_dispatch` under a 'model' axis larger than 1) is not ported:
ROADMAP.md queue 1 item 5b, step 2.

LayerMerge: routing is input-dependent and discontinuous, so an MoE
sublayer is prunable and never linearized.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_SHARDED = ("the expert-parallel MoE (moe_ffn_sharded, a 'model' mesh "
            "axis larger than 1) is not ported: ROADMAP.md queue 1 item 5b, "
            "step 2")


def moe_axes():
    return {
        "router": ("embed", "experts"),
        "w_gate": ("experts", "expert_embed", "expert_ffn"),
        "w_up": ("experts", "expert_embed", "expert_ffn"),
        "w_down": ("experts", "expert_ffn", "expert_embed"),
    }


def _normal(gen, shape, dtype, scale):
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def init_moe(cfg, gen: torch.Generator, dtype):
    d, e, dff = cfg.d_model, cfg.num_experts, cfg.moe_dff
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(dff)
    p = {
        "router": _normal(gen, (d, e), dtype, s_in),
        "w_gate": _normal(gen, (e, d, dff), dtype, s_in),
        "w_up": _normal(gen, (e, d, dff), dtype, s_in),
        "w_down": _normal(gen, (e, dff, d), dtype, s_out),
    }
    return p, moe_axes()


def route(p, xt, cfg, forced=None):
    """Top-k gating.  xt: (N, D) → (gates (N, k), experts (N, k) int64):
    the softmax over the router logits in fp32, its top k renormalized.

    ``forced`` — ``(top_g, top_e)`` returned in place of the router's
    choice — is a test hook: a CPU run wraps this function to replay the
    routing a card run chose (``chip_smoke.py`` phase 23), since a
    near-tie can flip under fp32 reassociation.  Nothing on the main path
    passes it."""
    if forced is not None:
        top_g, top_e = forced
        return (top_g.to(device=xt.device, dtype=xt.dtype),
                top_e.to(device=xt.device, dtype=torch.long))
    logits = (xt @ p["router"]).float()
    gates = torch.softmax(logits, dim=-1)
    top_g, top_e = torch.topk(gates, cfg.experts_per_token, dim=-1)
    top_g = top_g / top_g.sum(dim=-1, keepdim=True)
    return top_g.to(xt.dtype), top_e


def capacity_positions(top_e, num_experts, capacity):
    """First-come-first-served slot of each (token, slot) in its expert's
    buffer, and whether it fits: ``(pos (N, k), keep (N, k))``.

    Sort-based ranking: a stable argsort groups the pairs by expert in
    token order, and a pair's rank is its index in the sorted order less
    its expert's start (an exclusive cumsum of the per-expert counts)."""
    n, k = top_e.shape
    flat = top_e.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    counts = torch.zeros((num_experts,), dtype=torch.long,
                         device=flat.device).index_add_(
        0, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, dim=0) - counts
    ranks_sorted = torch.arange(n * k, device=flat.device) - starts[sorted_e]
    pos = torch.empty_like(flat).index_put_((order,), ranks_sorted)
    pos = pos.reshape(n, k)
    return pos, pos < capacity


def capacity_positions_cumsum(top_e, num_experts, capacity):
    """The one-hot-cumsum ranking (GShard's formulation), kept as the
    oracle of :func:`capacity_positions`; O(N·k·E) memory, toy sizes
    only."""
    n, k = top_e.shape
    onehot = F.one_hot(top_e.reshape(n * k), num_experts)
    pos = torch.cumsum(onehot, dim=0) - onehot
    pos = (pos * onehot).sum(dim=-1).reshape(n, k)
    return pos, pos < capacity


def _moe_group(p, xt, cfg, capacity):
    """Route and dispatch ``xt`` (N, D): ``(expert_in (E, C, D), (top_e,
    safe_pos, gate_kept))``."""
    e = cfg.num_experts
    top_g, top_e = route(p, xt, cfg)
    pos, keep = capacity_positions(top_e, e, capacity)
    gate_kept = top_g * keep.to(top_g.dtype)
    safe_pos = torch.where(keep, pos, capacity - 1)
    contrib = keep[..., None].to(xt.dtype)
    expert_in = torch.zeros((e, capacity, xt.shape[-1]), dtype=xt.dtype,
                            device=xt.device)
    expert_in.index_put_((top_e, safe_pos), xt[:, None, :] * contrib,
                         accumulate=True)
    return expert_in, (top_e, safe_pos, gate_kept)


def moe_ffn(p, x, cfg, *, capacity_factor: float = 1.25):
    """x: (B, S, D) → (B, S, D).  Top-k routing, capacity-dropped
    dispatch of the B·S tokens as one group (the JAX package's
    single-device case: capacity ``ceil(N·k/E · capacity_factor)``), the
    SwiGLU experts, and the gate-weighted combine."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    n = b * s
    capacity = max(int(math.ceil(n * k / e * capacity_factor)), 1)
    expert_in, (top_e, safe_pos, gate_kept) = _moe_group(
        p, x.reshape(n, d), cfg, capacity)
    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", expert_in, p["w_up"])
    expert_out = torch.einsum("ecf,efd->ecd", h, p["w_down"])
    out = (expert_out[top_e, safe_pos] * gate_kept[..., None]).sum(dim=1)
    return out.reshape(b, s, d)


def moe_dispatch(p, x, cfg, *, capacity_factor: float = 1.25, rules=None):
    """The model's entry point: :func:`moe_ffn` on this rank's tokens.
    ``rules`` (default: the ambient rules) with a 'model' axis larger than
    1 raises: the expert-parallel path waits in ROADMAP.md queue 1 item
    5b, step 2."""
    from repro_torch.sharding.rules import active_rules
    rules = rules if rules is not None else active_rules()
    if rules is not None and model_axis_size(rules) > 1:
        raise NotImplementedError(_SHARDED)
    return moe_ffn(p, x, cfg, capacity_factor=capacity_factor)


def model_axis_size(rules) -> int:
    """The size of a rules object's 'model' mesh axis (1 without one)."""
    mesh = getattr(rules, "mesh", None)
    return 1 if mesh is None else mesh.shape.get("model", 1)


def aux_load_balance_loss(p, x, cfg):
    """Switch-style load-balancing auxiliary (fraction·prob dot product)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs = torch.softmax((xt @ p["router"]).float(), dim=-1)
    top_e = torch.argmax(probs, dim=-1)
    frac = F.one_hot(top_e, cfg.num_experts).float().mean(dim=0)
    prob = probs.mean(dim=0)
    return cfg.num_experts * torch.sum(frac * prob)
