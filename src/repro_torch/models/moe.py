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

:func:`moe_ffn` is the JAX package's grouped dispatch: the tokens in
``num_groups`` contiguous groups, each routed with the capacity of its
own tokens.  Under a mesh each rank routes its own rows of the batch,
one group a data block (a group per data shard); a single device routes
in as many groups inside :func:`grouped_routing`, so its drops are the
sharded step's.
Under a 'model' axis that divides the experts, :func:`moe_dispatch` takes
the expert-parallel path (:func:`moe_ffn_sharded`, the reference's
``shard_map`` body): each rank routes its tokens against the whole
router, fills an ``(E/model, C, D)`` buffer of its own experts only (C
from the tokens of one data block), runs their products and sums the
token outputs over 'model' (one token-sized all-reduce).  The router is
gathered over 'model' and its gradient reduce-scattered back; the tokens
enter the split experts with their gradient summed over 'model'
(:mod:`repro_torch.sharding.collectives`), so it trains as it serves.
Where the experts do not divide, or the rules set ``moe_shard_map`` to
False, the grouped path runs on the whole expert weights.

LayerMerge: routing is input-dependent and discontinuous, so an MoE
sublayer is prunable and never linearized.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from repro_torch.device import draw_device
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import active_rules


def moe_axes():
    return {
        "router": ("embed", "experts"),
        "w_gate": ("experts", "expert_embed", "expert_ffn"),
        "w_up": ("experts", "expert_embed", "expert_ffn"),
        "w_down": ("experts", "expert_ffn", "expert_embed"),
    }


def _normal(gen, shape, dtype, scale):
    return (torch.randn(shape, generator=gen, device=draw_device(gen))
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


_GROUPS = threading.local()


@contextlib.contextmanager
def grouped_routing(num_groups: int):
    """Within the block, :func:`moe_ffn` calls given no ``num_groups`` and
    run outside a mesh route in ``num_groups`` groups: a single device's
    stand-in for the data groups of a mesh (so a one-device step routes,
    and drops, as the sharded step that routes each data block alone)."""
    prev = getattr(_GROUPS, "n", None)
    _GROUPS.n = int(num_groups)
    try:
        yield
    finally:
        _GROUPS.n = prev


def default_groups() -> int:
    """The group count ``moe_ffn(num_groups=None)`` takes: the product of
    the ambient rules' 'pod' and 'data' sizes under a mesh, else the
    :func:`grouped_routing` count, else 1."""
    r = active_rules()
    if r is not None:
        return math.prod(r.mesh.shape[a] for a in ("pod", "data")
                         if a in r.mesh.shape)
    return getattr(_GROUPS, "n", None) or 1


def _moe_tokens(p, xt, cfg, capacity):
    """Route, dispatch, run the experts and combine the tokens ``xt``
    (N, D) as one group of ``capacity`` slots an expert."""
    expert_in, (top_e, safe_pos, gate_kept) = _moe_group(p, xt, cfg,
                                                         capacity)
    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", expert_in, p["w_up"])
    expert_out = torch.einsum("ecf,efd->ecd", h, p["w_down"])
    return (expert_out[top_e, safe_pos] * gate_kept[..., None]).sum(dim=1)


def moe_ffn(p, x, cfg, *, capacity_factor: float = 1.25,
            num_groups: int | None = None):
    """x: (B, S, D) → (B, S, D).  Top-k routing, capacity-dropped
    dispatch, the SwiGLU experts and the gate-weighted combine, in the
    JAX package's grouped dispatch: the B·S tokens in ``g = gcd(
    num_groups, B·S)`` contiguous groups, each routed alone with capacity
    ``ceil((B·S/g)·k/E · capacity_factor)``.  ``num_groups=None`` is
    :func:`default_groups`."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    n = b * s
    if num_groups is None:
        num_groups = default_groups()
    g = max(1, math.gcd(int(num_groups), n))
    capacity = max(int(math.ceil(n / g * k / e * capacity_factor)), 1)
    xt = x.reshape(g, n // g, d)
    out = [_moe_tokens(p, xt[i], cfg, capacity) for i in range(g)]
    return (out[0] if g == 1 else torch.cat(out)).reshape(b, s, d)


def _whole_over_model(t, dim: int, n: int, mesh):
    """``t`` gathered along ``dim`` over 'model' where it holds a block of
    ``n`` (every rank then computes with it alike: the gradient's block
    comes back)."""
    if t.shape[dim] == n:
        return t
    return C.all_gather(t, mesh, "model", dim=dim)


def moe_ffn_sharded(p, x, cfg, *, capacity_factor: float = 1.25, rules=None):
    """The expert-parallel MoE on this rank's tokens ``x`` (its rows of
    the batch, replicated over 'model'): ``(B, S, D)`` whole on every
    rank of 'model'.  The capacity ``C = ceil(N·k/E · capacity_factor)``
    counts the N tokens of this data block; ranking is over every expert
    (as the single device's group), and only the (token, slot) pairs of
    this rank's ``E/model`` experts fill its buffer.  Weights may be the
    rank's expert blocks or whole (a whole weight is cut to the rank's
    experts)."""
    rules = rules if rules is not None else active_rules()
    mesh = rules.mesh
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    e_loc = e // mesh.shape["model"]
    e0 = mesh.index("model") * e_loc
    n = b * s
    capacity = max(int(math.ceil(n * k / e * capacity_factor)), 1)
    router = p["router"]
    if router.shape[1] < e:
        router = C.gather_weight(router, mesh, "model", dim=1)
    w = {}
    for name in ("w_gate", "w_up", "w_down"):
        w[name] = p[name] if p[name].shape[0] == e_loc \
            else p[name][e0:e0 + e_loc]
    xt = C.enter_split(x, mesh, "model").reshape(n, d)
    top_g, top_e = route({"router": router}, xt, cfg)
    pos, keep = capacity_positions(top_e, e, capacity)
    local_slot = top_e - e0
    contrib = keep & (local_slot >= 0) & (local_slot < e_loc)
    safe_slot = torch.where(contrib, local_slot, 0)
    safe_pos = torch.where(contrib, pos, capacity - 1)
    cmask = contrib[..., None].to(xt.dtype)
    buf = torch.zeros((e_loc, capacity, d), dtype=xt.dtype,
                      device=xt.device).index_put(
        (safe_slot, safe_pos), xt[:, None, :] * cmask, accumulate=True)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, w["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, w["w_up"])
    out_buf = torch.einsum("ecf,efd->ecd", h, w["w_down"])
    part = out_buf[safe_slot, safe_pos] * (top_g[..., None] * cmask)
    return C.all_reduce(part.sum(dim=1), mesh, "model").reshape(b, s, d)


def moe_dispatch(p, x, cfg, *, capacity_factor: float = 1.25, rules=None):
    """The model's entry point.  ``rules`` (default: the ambient rules)
    with a 'model' axis that divides the experts (and ``moe_shard_map``
    not False) take :func:`moe_ffn_sharded`; otherwise :func:`moe_ffn`
    runs on this rank's tokens, with the expert weights gathered whole
    where they are 'model' blocks."""
    rules = rules if rules is not None else active_rules()
    n_model = model_axis_size(rules)
    if n_model > 1 and cfg.num_experts % n_model == 0 \
            and rules.rules.get("moe_shard_map", True):
        return moe_ffn_sharded(p, x, cfg, capacity_factor=capacity_factor,
                               rules=rules)
    if n_model > 1:
        e = cfg.num_experts
        p = {"router": _whole_over_model(p["router"], 1, e, rules.mesh),
             **{name: _whole_over_model(p[name], 0, e, rules.mesh)
                for name in ("w_gate", "w_up", "w_down")}}
    # under a mesh ``x`` is this rank's data block: one group
    return moe_ffn(p, x, cfg, capacity_factor=capacity_factor,
                   num_groups=1 if getattr(rules, "mesh", None) is not None
                   else None)


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
