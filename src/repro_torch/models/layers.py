"""Transformer building blocks — plain functions over explicit param trees.

The JAX package's ``models/layers.py`` in PyTorch, with its names, layouts
and logical-axis records: attention weights ``wq (D, H, hd)``,
``wk``/``wv (D, KVH, hd)``, ``wo (H, hd, D)``; FFN ``w_up``/``w_gate
(D, F)``, ``w_down (F, D)``; activations ``(B, S, D)``.  Every ``init_*``
returns ``(params, axes)`` and draws from an explicit
``torch.Generator``.

The norms and prefill attention go through the port's kernel ops:
:func:`rms_norm` through ``rmsnorm_op`` and :func:`attention` through
``flash_attention_op`` whenever its mask is plain causal — the hand-written
``rmsnorm`` and ``flash_attention`` kernels on the card, their plain
versions on the CPU (where the JAX package's layers are plain ``jnp``: the
two agree to fp32 reassociation).  A local-window prefill longer than its
window keeps the plain masked softmax (:func:`_sdpa`), and one-token
decode against the KV cache stays plain.  The FFN and the embedding are
plain PyTorch.  M-RoPE and the sharded flash-decoding path are not ported
(ROADMAP.md queue 1).

Decode caches are updated in place (the JAX package returns new arrays):
``attention_decode`` writes the new key and value into the cache tensors
and advances ``pos``, an int32 tensor on the cache's device (0-d, or one
position per row), and returns the same dict.  The position, the slot
and the mask are computed on the device, so a decode step reads nothing
on the host and can be captured in a CUDA graph
(:mod:`repro_torch.runtime.serving`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention_op, rmsnorm_op

_NOT_PORTED = ("{what} is not ported: the port runs dense attention "
               "and RG-LRU transformers (ROADMAP.md queue 1)")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    """``x · rsqrt(mean x² + eps) · (1 + g)`` through ``rmsnorm_op``: fp32
    throughout, cast to ``x.dtype`` at the end.  The JAX package's layer
    casts the rsqrt to ``x.dtype`` first; at fp32, the only dtype the
    port's transformer host runs, the two are the same function."""
    return rmsnorm_op(x.contiguous(), scale.contiguous(), eps=eps)


def init_rmsnorm(d, dtype):
    return torch.zeros((d,), dtype=dtype), ("embed",)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    ang = positions[..., None].float() * freqs              # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA, causal, optional local window, KV cache)
# ---------------------------------------------------------------------------

def attention_axes(cfg):
    ax = {"wq": ("embed", "heads", "head"), "wk": ("embed", "kv", "head"),
          "wv": ("embed", "kv", "head"), "wo": ("heads", "head", "embed")}
    if cfg.qkv_bias:
        ax.update({"bq": ("heads", "head"), "bk": ("kv", "head"),
                   "bv": ("kv", "head")})
    return ax


def _normal(gen, shape, dtype, scale):
    return (torch.randn(shape, generator=gen) * scale).to(dtype)


def init_attention(cfg, gen: torch.Generator, dtype):
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    p = {"wq": _normal(gen, (d, h, hd), dtype, s),
         "wk": _normal(gen, (d, kvh, hd), dtype, s),
         "wv": _normal(gen, (d, kvh, hd), dtype, s),
         "wo": _normal(gen, (h, hd, d), dtype, s)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype)
        p["bk"] = torch.zeros((kvh, hd), dtype=dtype)
        p["bv"] = torch.zeros((kvh, hd), dtype=dtype)
    return p, attention_axes(cfg)


def _qkv(p, x, cfg, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.rope_kind == "mrope":
        raise NotImplementedError(_NOT_PORTED.format(what="M-RoPE"))
    if cfg.rope_kind != "none":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask):
    """Reference scaled-dot-product attention with GQA head grouping.

    q: (B, Sq, H, D); k, v: (B, Skv, KVH, D); mask: (B|1, 1, Sq, Skv) bool.
    """
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    group = h // kvh
    qg = q.reshape(b, sq, kvh, group, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k) / math.sqrt(d)
    logits = logits.float()
    neg = torch.finfo(torch.float32).min
    logits = torch.where(mask[:, :, None] if mask.ndim == 4 else mask,
                         logits, neg)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, sq, h, d)


def causal_mask(sq, skv, offset=0, window: int = 0, device=None):
    """(1, 1, sq, skv) bool; ``offset`` = absolute position of q[0]."""
    qpos = torch.arange(sq, device=device)[:, None] + offset
    kpos = torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m[None, None]


def attention(p, x, cfg, positions, *, window: int = 0):
    """Full (prefill) causal attention.

    The mask decides the route, from the shape alone: with no window, or
    a window no shorter than the sequence, the mask is plain causal and
    the attention goes through ``flash_attention_op`` (k and v keep their
    KVH heads; query head h reads kv head ``h // (H / KVH)``, the grouping
    of :func:`_sdpa`).  A sequence longer than its local window takes the
    plain masked softmax.  Neither is a fallback for the other."""
    q, k, v = _qkv(p, x, cfg, positions)
    s = x.shape[1]
    if window == 0 or s <= window:
        out = flash_attention_op(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True)
    else:
        out = _sdpa(q, k, v, causal_mask(s, s, 0, window, x.device))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def attention_decode(p, x, cfg, cache, *, window: int = 0):
    """One-token decode against a KV cache, written in place.

    cache: {"k": (B, S, KVH, D), "v": ..., "pos": int32 tensor} — ``pos``
    is the number of tokens already in the cache: 0-d (every row at one
    position) or ``(B,)`` (a position per row, the continuous engine's
    slots).  For windowed attention the cache is a ring buffer of ``S``
    entries.  Per row, the new key and value go to slot ``pos % S``
    (windowed) or ``pos``, by a device index, the RoPE position and the
    mask are that row's, and ``pos`` is advanced in place.

    A plain cache's write index is clamped to ``S - 1``: a row past the
    end overwrites its last entry, the JAX package's
    ``dynamic_update_slice`` semantics, and never writes out of range.
    The single-batch serving paths never reach the clamp: they refuse,
    on the host and before the first step, a prompt plus tokens longer
    than the cache (:func:`repro_torch.runtime.serving.check_room`).
    Only the continuous engine's idle or finished rows run past the end,
    and their outputs are discarded.
    """
    pos = cache["pos"]
    rows = pos.expand(x.shape[0])[:, None]                  # (B, 1)
    q, k, v = _qkv(p, x, cfg, rows)
    size = cache["k"].shape[1]
    slot = (torch.remainder(rows, size) if window > 0
            else torch.clamp(rows, max=size - 1))
    at = (torch.arange(x.shape[0], device=x.device), slot[:, 0].long())
    cache["k"].index_put_(at, k[:, 0])
    cache["v"].index_put_(at, v[:, 0])
    kpos = torch.arange(size, device=x.device)[None, :]     # (1, S)
    if window > 0:
        # ring buffer: entry i holds absolute position derived from slot
        abs_pos = torch.where(kpos <= slot, rows - slot + kpos,
                              rows - slot - size + kpos)
        valid = (abs_pos >= 0) & (abs_pos <= rows) & (abs_pos > rows - size)
    else:
        valid = kpos <= rows
    out = _sdpa(q, cache["k"], cache["v"], valid[:, None, None, :])
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    pos.add_(1)
    return y, cache


def init_cache(cfg, batch, seq_len, dtype, window: int = 0, device=None):
    """A zeroed KV cache of ``seq_len`` entries, or for windowed attention
    a ring buffer of ``min(seq_len, window)``.  ``"ring"`` (a Python bool)
    marks a ring buffer of the whole window: it serves any number of
    positions; any other cache serves ``seq_len``."""
    size = min(seq_len, window) if window > 0 else seq_len
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device),
            "ring": window > 0 and size == window}


CACHE_AXES = {"k": ("batch", "kv_seq", "kv", "head"),
              "v": ("batch", "kv_seq", "kv", "head"), "pos": ()}


# ---------------------------------------------------------------------------
# FFN family (GeGLU / SwiGLU / GELU)
# ---------------------------------------------------------------------------

def ffn_axes(kind):
    ax = {"w_up": ("embed", "ffn"), "w_down": ("ffn", "embed")}
    if kind in ("geglu", "swiglu"):
        ax["w_gate"] = ("embed", "ffn")
    return ax


def init_ffn(d, dff, kind, gen: torch.Generator, dtype):
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(dff)
    p = {"w_up": _normal(gen, (d, dff), dtype, s_in),
         "w_down": _normal(gen, (dff, d), dtype, s_out)}
    if kind in ("geglu", "swiglu"):
        p["w_gate"] = _normal(gen, (d, dff), dtype, s_in)
    return p, ffn_axes(kind)


def ffn(p, x, kind):
    """``jax.nn.gelu``'s default is the tanh approximation: so is this."""
    up = x @ p["w_up"]
    if kind == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * up
    elif kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ p["w_down"]


def init_embedding(vocab, d, gen: torch.Generator, dtype):
    return _normal(gen, (vocab, d), dtype, 1.0 / math.sqrt(d)), \
        ("vocab", "embed")
