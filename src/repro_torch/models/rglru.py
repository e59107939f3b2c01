"""RG-LRU recurrence block (RecurrentGemma / Griffin, arXiv:2402.19427).

The JAX package's ``models/rglru.py`` in PyTorch, with its parameter
names, layouts and logical axes.  The temporal mixing block is: linear in
and out projections, a width-4 depthwise causal conv, and the Real-Gated
Linear Recurrence Unit::

    r_t = σ(x_t W_a)                     (recurrence gate)
    i_t = σ(x_t W_x)                     (input gate)
    a_t = exp(-c · softplus(Λ) · r_t)    (per-channel decay, c = 8)
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

For prefill, the probes and training the recurrence runs through
:func:`rglru_scan` and :func:`repro_torch.kernels.rglru_scan_op` — the
hand-written ``rglru_scan`` kernels on the card (the forward, and the
backward for its gradient), a sequential loop on the CPU — where the JAX
package uses ``lax.associative_scan``: the two agree to fp32
reassociation, not bitwise.  Decode is one fused state update in plain PyTorch (the JAX
package keeps it in XLA), written into the state's tensors in place.  The conv is plain PyTorch too; it is no kernel
in the JAX package either.

``jax.nn.gelu`` defaults to the tanh approximation and ``jax.nn.softplus``
is ``logaddexp(x, 0)``: so are these.  LayerMerge: the gates depend on the
input, so the block is prunable and not linearizable.

Under a mesh the recurrence width ('ffn') is split over 'model': each rank
holds its columns of ``w_in``, the conv, ``lam`` and its rows of ``w_a``,
``w_x`` and ``w_out``, and runs the conv, the scan and the state on its
channels.  The gates' inputs contract the split width, so their two
products are summed over 'model' (one all-reduce) before each rank takes
its columns; the output projection returns the rank's partial
(:func:`rglru_partial`), which the unit sums.  The state follows
``RGLRU_STATE_AXES``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import draw_device
from repro_torch.kernels import rglru_scan_op
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import active_rules, local_shape

C_DECAY = 8.0


def rglru_axes():
    return {"w_in": ("embed", "ffn"), "w_out": ("ffn", "embed"),
            "conv_w": (None, "ffn"), "conv_b": ("ffn",),
            "w_a": ("ffn", "ffn_in"), "w_x": ("ffn", "ffn_in"),
            "lam": ("ffn",)}


def _normal(gen, shape, dtype, scale):
    return (torch.randn(shape, generator=gen, device=draw_device(gen))
            * scale).to(dtype)


def init_rglru(cfg, gen: torch.Generator, dtype):
    """``(params, axes)`` drawn from ``gen`` on its device: the JAX package's
    scales, and Λ such that ``-log a`` (at r = 1) is ``C_DECAY`` times
    ``-log`` of a uniform draw in (0.9^C, 0.999^C)."""
    d = cfg.d_model
    dr = cfg.rnn_width or d
    u = torch.empty((dr,), device=draw_device(gen)).uniform_(
        0.9 ** C_DECAY, 0.999 ** C_DECAY, generator=gen)
    p = {
        "w_in": _normal(gen, (d, dr), dtype, 1.0 / math.sqrt(d)),
        "w_out": _normal(gen, (dr, d), dtype, 1.0 / math.sqrt(dr)),
        "conv_w": _normal(gen, (4, dr), dtype, 0.1),
        "conv_b": torch.zeros((dr,), dtype=dtype),
        "w_a": _normal(gen, (dr, dr), dtype, 1.0 / math.sqrt(dr)),
        "w_x": _normal(gen, (dr, dr), dtype, 1.0 / math.sqrt(dr)),
        "lam": torch.log(torch.expm1(-torch.log(u))).to(dtype),
    }
    return p, rglru_axes()


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def rglru_partial(p, cfg) -> bool:
    """Whether the block's output on these weights is a partial over
    'model' (the recurrence width split)."""
    return p["w_out"].shape[0] < (cfg.rnn_width or cfg.d_model)


def _gate_inputs(p, u):
    """``u @ W_a`` and ``u @ W_x`` on this rank's channels: where ``u``
    holds a block of the width, the two products are partials of the
    whole width, summed over 'model' (one all-reduce), then cut to the
    rank's columns."""
    ra, ix = u @ p["w_a"], u @ p["w_x"]
    local = p["w_a"].shape[0]
    if local == p["w_a"].shape[1]:
        return ra, ix
    mesh = active_rules().mesh
    # the sum is whole on every rank and each keeps its columns: entering
    # the split channels, its gradient is summed over 'model'
    both = C.enter_split(C.all_reduce(torch.cat([ra, ix], dim=-1), mesh,
                                      "model"), mesh, "model")
    c0 = mesh.index("model") * local
    width = ra.shape[-1]
    return (both[..., c0:c0 + local],
            both[..., width + c0:width + c0 + local])


def _gates(p, u):
    ra, ix = _gate_inputs(p, u)
    r = torch.sigmoid(ra)
    i = torch.sigmoid(ix)
    log_a = -C_DECAY * _softplus(p["lam"].float()) * r.float()
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i.float() * u.float())
    return a, gated


def _causal_conv1d(p, u, state=None):
    """Width-4 depthwise causal conv over (B, S, Dr); ``state`` (B, 3, Dr)
    holds the trailing inputs of the previous call (zeros at the start)."""
    w, b = p["conv_w"], p["conv_b"]
    k = w.shape[0]
    if state is None:
        pad = F.pad(u, (0, 0, k - 1, 0))
    else:
        pad = torch.cat([state.to(u.dtype), u], dim=1)
    out = sum(pad[:, i:i + u.shape[1]] * w[i] for i in range(k)) + b
    return out, pad[:, -(k - 1):]


def rglru_scan(a, gated, h0=None):
    """``h_t = a_t h_{t-1} + gated_t`` over axis 1 of (B, S, C), from
    ``h0`` (B, C) or zeros: ``a_0 h0`` is folded into ``gated_0`` as the
    JAX package folds it, then :func:`rglru_scan_op` runs the scan (its
    kernels on the card), differentiable in a, gated and h0."""
    if h0 is not None:
        gated = torch.cat([gated[:, :1] + a[:, :1] * h0[:, None],
                           gated[:, 1:]], dim=1)
    return rglru_scan_op(a.contiguous(), gated.contiguous())


def rglru_block(p, x, cfg):
    """Full temporal block for prefill: (B, S, D) → (B, S, D)."""
    if rglru_partial(p, cfg):
        x = C.enter_split(x, active_rules().mesh, "model")
    u = x @ p["w_in"]
    u, _ = _causal_conv1d(p, u)
    a, gated = _gates(p, u)
    h = rglru_scan(a, gated)
    return (h.to(x.dtype) * F.gelu(u, approximate="tanh")) @ p["w_out"]


def rglru_decode(p, x, cfg, state):
    """One-step decode: x (B, 1, D); state ``{"h": (B, Dr) fp32, "conv":
    (B, 3, Dr)}`` → ``(y, state)``, the state written in place (its
    tensors keep their storage, so a captured step replays against
    them).  The conv window is shifted through a new tensor (the
    concatenation of the old window and the input), never copied onto
    itself."""
    u = x @ p["w_in"]
    u, conv_state = _causal_conv1d(p, u, state["conv"])
    a, gated = _gates(p, u)
    h = a[:, 0] * state["h"] + gated[:, 0]
    y = (h[:, None].to(x.dtype) * F.gelu(u, approximate="tanh")) @ p["w_out"]
    state["h"].copy_(h)
    state["conv"].copy_(conv_state)
    return y, state


def init_rglru_state(cfg, batch, dtype, device=None):
    """The zeroed state; under a mesh this rank's block of
    ``RGLRU_STATE_AXES`` (its batch rows and channels)."""
    dr = cfg.rnn_width or cfg.d_model
    h_shape, _ = local_shape(RGLRU_STATE_AXES["h"], (batch, dr))
    conv_shape, _ = local_shape(RGLRU_STATE_AXES["conv"], (batch, 3, dr))
    return {"h": torch.zeros(h_shape, dtype=torch.float32, device=device),
            "conv": torch.zeros(conv_shape, dtype=dtype, device=device)}


RGLRU_STATE_AXES = {"h": ("batch", "ffn"), "conv": ("batch", None, "ffn")}
