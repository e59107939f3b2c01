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
two agree to fp32 reassociation at fp32; at bf16 the port computes the TPU
kernels' function, fp32 inside and one rounding at the end).  A local-window prefill longer than its
window keeps the plain masked softmax (:func:`_sdpa`), and one-token
decode against the KV cache stays plain.  The FFN, the embedding and the
rotary embeddings (RoPE, and Qwen2-VL's three-stream M-RoPE,
:func:`apply_mrope`) are plain PyTorch.

Under a mesh (:func:`repro_torch.sharding.rules.use_rules`) the blocks
take this rank's shards of their weights, as the rules split them
('heads', 'kv' and 'ffn' on 'model') and return this rank's PARTIAL of
the output projection where its contraction is split
(:func:`attention_partial`, :func:`ffn_partial`): the unit sums the
partials (:mod:`repro_torch.runtime.executor`,
:func:`repro_torch.models.transformer.decode_step`).  A loss
differentiates through them: the sum's gradient passes through, and the
replicated input of a split block (:func:`attention`'s, the FFN's
through :func:`repro_torch.models.transformer.split_input`, the
unembedding's) sums its partial gradients over 'model'
(:func:`repro_torch.sharding.collectives.enter_split`).  A dimension the
mesh does not divide (SmolLM's 9 heads on a 'model' axis of 2) stays
whole and its block computes whole, with no collective.  The embedding
(:func:`embed`) and unembedding (:func:`unembed_logits`) take a vocab
slice.  Decode caches follow ``CACHE_AXES``: 'kv_seq' on 'model' (so
'kv' stays whole in the cache), the batch on the data axes.  A cache
split along its sequence carries ``"kv_seq": (start, size)``; decode
writes the new token's key and value only on the rank whose slice holds
its slot — a masked in-place write driven by the device tensor ``pos``,
nothing decided on the host, so a captured step replays it — and
combines the slices by flash-decoding
(:func:`repro_torch.sharding.collectives.flash_decode_attention`): the
query whole over 'model' (its heads gathered where they are split), a
slice with no valid entry weighted zero.

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

from repro_torch.device import draw_device
from repro_torch.kernels import flash_attention_op, rmsnorm_op
from repro_torch.sharding import collectives as C
from repro_torch.sharding.rules import active_rules, local_shape

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    """``x · rsqrt(mean x² + eps) · (1 + g)`` through ``rmsnorm_op``: fp32
    throughout, cast to ``x.dtype`` once, at the end — the TPU kernel's
    function (``repro.kernels.rmsnorm``), which the card's bf16 body
    computes.  The JAX package's layer differs at bf16: it rounds the
    rsqrt to bf16 first and multiplies in bf16, so the two differ by a
    few bf16 ulps of y (a deliberate divergence: the port follows the
    kernel; the CPU tests bound the gap).  At fp32 they are the same
    function."""
    return rmsnorm_op(x.contiguous(), scale.contiguous(), eps=eps)


def init_rmsnorm(d, dtype):
    return torch.zeros((d,), dtype=dtype), ("embed",)


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE and multimodal M-RoPE)
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


def apply_mrope(x, positions3, theta: float = 10000.0,
                sections=(0.25, 0.375, 0.375)):
    """Qwen2-VL M-RoPE: the rotary frequencies split into (temporal,
    height, width) sections, each rotated by its own position stream.

    x: (B, S, H, D); positions3: (3, B, S).  The section sizes are
    Python's ``round`` of ``fraction · D/2`` (banker's rounding, as the
    JAX package computes them), the last taking the remainder."""
    d = x.shape[-1]
    half = d // 2
    sec = [int(round(s * half)) for s in sections]
    sec[-1] = half - sum(sec[:-1])
    freqs = rope_freqs(d, theta, x.device)                  # (half,)
    pos = torch.cat([positions3[i][..., None].expand(
        *positions3[i].shape, n) for i, n in enumerate(sec)], dim=-1)
    ang = pos.float() * freqs                               # (B, S, half)
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
    return (torch.randn(shape, generator=gen, device=draw_device(gen))
            * scale).to(dtype)


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


def _qkv(p, x, cfg, positions, mrope_positions=None):
    """Projections and rotary embedding.  An M-RoPE config given no
    position streams rotates by ``positions`` with plain RoPE, as the JAX
    package does."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.rope_kind == "mrope" and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.rope_theta)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta)
    elif cfg.rope_kind != "none":
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


def _model_index() -> int:
    return active_rules().mesh.index("model")


def _kv_for_heads(q, k, v, cfg):
    """k and v (B, S, ·, D) for the query heads ``q`` holds (B, S, H_l,
    D): under a mesh that splits the heads, the kv heads the local query
    heads read (query head h reads kv head h // (H / KVH)), a slice where
    they form whole groups, else one kv head per query head; k and v as
    they are where q holds every head."""
    hl, kl = q.shape[2], k.shape[2]
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    if hl == H and kl == KVH:
        return k, v
    idx_m = _model_index()
    h0 = idx_m * hl if hl < H else 0
    k0 = idx_m * kl if kl < KVH else 0
    g = H // KVH
    idx = [(h0 + i) // g - k0 for i in range(hl)]
    lo, n = idx[0], idx[-1] + 1 - idx[0]
    if hl % n == 0 and idx == [lo + i // (hl // n) for i in range(hl)]:
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def attention_partial(p, cfg) -> bool:
    """Whether :func:`attention` / :func:`attention_decode` on these
    weights return a partial over 'model' (the heads split)."""
    return p["wo"].shape[0] < cfg.num_heads


def causal_mask(sq, skv, offset=0, window: int = 0, device=None):
    """(1, 1, sq, skv) bool; ``offset`` = absolute position of q[0]."""
    qpos = torch.arange(sq, device=device)[:, None] + offset
    kpos = torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m[None, None]


def attention(p, x, cfg, positions, *, window: int = 0,
              mrope_positions=None):
    """Full (prefill) causal attention.

    The mask decides the route, from the shape alone: with no window, or
    a window no shorter than the sequence, the mask is plain causal and
    the attention goes through ``flash_attention_op`` (k and v keep their
    KVH heads; query head h reads kv head ``h // (H / KVH)``, the grouping
    of :func:`_sdpa`).  A sequence longer than its local window takes the
    plain masked softmax.  Neither is a fallback for the other.
    ``mrope_positions`` (3, B, S): M-RoPE's position streams."""
    if attention_partial(p, cfg):
        x = C.enter_split(x, active_rules().mesh, "model")
    q, k, v = _qkv(p, x, cfg, positions, mrope_positions)
    k, v = _kv_for_heads(q, k, v, cfg)
    s = x.shape[1]
    if window == 0 or s <= window:
        out = flash_attention_op(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True)
    else:
        out = _sdpa(q, k, v, causal_mask(s, s, 0, window, x.device))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def attention_decode(p, x, cfg, cache, *, window: int = 0,
                     mrope_positions=None):
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
    and their outputs are discarded.  ``mrope_positions`` (3, B, 1):
    M-RoPE's position streams of the new token (its rotary positions;
    the cache slot and the mask still follow ``pos``).

    A cache split along its sequence over 'model' (``"kv_seq": (start,
    size)``, :func:`init_cache` under a mesh) holds entries ``start ..
    start + S_l`` of ``size``: the slot is computed over ``size``, the
    rank whose slice holds it writes (the others write back the entry
    they hold), and the slices combine by flash-decoding.
    """
    pos = cache["pos"]
    rows = pos.expand(x.shape[0])[:, None]                  # (B, 1)
    q, k, v = _qkv(p, x, cfg, rows, mrope_positions)
    ck, cv = cache["k"], cache["v"]
    local = ck.shape[1]
    start, size = cache.get("kv_seq", (0, local))
    if k.shape[2] < ck.shape[2]:          # kv heads split, the cache's whole
        mesh = active_rules().mesh
        k = C.all_gather(k, mesh, "model", dim=2)
        v = C.all_gather(v, mesh, "model", dim=2)
    slot = (torch.remainder(rows, size) if window > 0
            else torch.clamp(rows, max=size - 1))
    b = torch.arange(x.shape[0], device=x.device)
    if "kv_seq" in cache:
        li = slot - start
        inside = ((li >= 0) & (li < local))[:, :, None]      # (B, 1, 1)
        at = (b, torch.clamp(li, 0, local - 1)[:, 0].long())
        ck.index_put_(at, torch.where(inside, k[:, 0], ck[at]))
        cv.index_put_(at, torch.where(inside, v[:, 0], cv[at]))
    else:
        at = (b, slot[:, 0].long())
        ck.index_put_(at, k[:, 0])
        cv.index_put_(at, v[:, 0])
    kpos = torch.arange(start, start + local, device=x.device)[None, :]
    if window > 0:
        # ring buffer: entry i holds absolute position derived from slot
        abs_pos = torch.where(kpos <= slot, rows - slot + kpos,
                              rows - slot - size + kpos)
        valid = (abs_pos >= 0) & (abs_pos <= rows) & (abs_pos > rows - size)
    else:
        valid = kpos <= rows
    if "kv_seq" in cache:
        mesh = active_rules().mesh
        hl = q.shape[2]
        qw = q if hl == cfg.num_heads else \
            C.all_gather(q, mesh, "model", dim=2)
        out = C.flash_decode_attention(qw[:, 0], ck, cv, valid,
                                       mesh=mesh)[:, None]
        if p["wo"].shape[0] < cfg.num_heads:
            h0 = mesh.index("model") * p["wo"].shape[0]
            out = out[:, :, h0:h0 + p["wo"].shape[0]]
    else:
        kk, vv = _kv_for_heads(q, ck, cv, cfg)
        out = _sdpa(q, kk, vv, valid[:, None, None, :])
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    pos.add_(1)
    return y, cache


def init_cache(cfg, batch, seq_len, dtype, window: int = 0, device=None):
    """A zeroed KV cache of ``seq_len`` entries, or for windowed attention
    a ring buffer of ``min(seq_len, window)``.  ``"ring"`` (a Python bool)
    marks a ring buffer of the whole window: it serves any number of
    positions; any other cache serves ``seq_len``.

    Under a mesh the cache is this rank's block of ``CACHE_AXES``: its
    rows of the batch, and its slice of the sequence (``"kv_seq":
    (start, size)``) or of the kv heads, where the mesh divides them."""
    size = min(seq_len, window) if window > 0 else seq_len
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    lshape, spec = local_shape(CACHE_AXES["k"], shape)
    out = {"k": torch.zeros(lshape, dtype=dtype, device=device),
           "v": torch.zeros(lshape, dtype=dtype, device=device),
           "pos": torch.zeros((), dtype=torch.int32, device=device),
           "ring": window > 0 and size == window}
    if len(spec) > 1 and spec[1] is not None:
        out["kv_seq"] = (C.block(size, active_rules().mesh, spec[1])[0],
                         size)
    return out


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


def ffn_partial(p, cfg) -> bool:
    """Whether :func:`ffn` on these weights returns a partial over
    'model' (the hidden width split)."""
    return p["w_down"].shape[0] < cfg.d_ff


def ffn(p, x, kind):
    """``jax.nn.gelu``'s default is the tanh approximation: so is this.
    On a rank's 'ffn' shards it returns the rank's partial."""
    up = x @ p["w_up"]
    if kind == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * up
    elif kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ p["w_down"]


def merged_ffn(u, v, x):
    """LayerMerge's rank-r residual map ``x + (x·U)·V`` in plain PyTorch:
    the oracle of the ``merged_ffn`` kernel, which the compressed forward
    runs (:func:`repro_torch.models.transformer.merged_residual`)."""
    return x + (x @ u) @ v


def embed(table, tokens, vocab: int):
    """Rows of ``table`` for ``tokens``.  A vocab slice of the table
    (this rank's block on 'model') gathers the ids it holds, zeros the
    others, and the sum over 'model' completes every row (one rank
    holds each id, so the sum is exact)."""
    if table.shape[0] == vocab:
        return table[tokens.long()]
    mesh = active_rules().mesh
    start = mesh.index("model") * table.shape[0]
    loc = tokens.long() - start
    inside = (loc >= 0) & (loc < table.shape[0])
    rows = table[torch.clamp(loc, 0, table.shape[0] - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return C.all_reduce(rows, mesh, "model")


def unembed_logits(x, w, vocab: int, gather: bool = True):
    """``x @ w`` (w (D, V)), the vocab slices gathered over 'model' where
    ``w`` is this rank's block of the vocab (``x``, replicated over
    'model', entering the split product: its gradient is summed over
    'model'); with ``gather=False`` this rank's slice of the logits."""
    if w.shape[1] == vocab:
        return x @ w
    mesh = active_rules().mesh
    y = C.enter_split(x, mesh, "model") @ w
    return C.all_gather(y, mesh, "model", dim=-1) if gather else y


def vocab_parallel_nll(logits, targets):
    """(B, S) negative log-likelihood of ``targets`` from this rank's
    vocab slice of fp32 ``logits`` (B, S, V/model; the slices in 'model'
    order), without gathering them: the max, the sum of exponentials and
    the target's logit are reduced over 'model' (Megatron's vocab-parallel
    cross-entropy).  The max is a constant of the gradient (it cancels);
    the two sums pass their gradients through, so each rank's slice gets
    ``softmax - onehot`` of its own vocab."""
    mesh = active_rules().mesh
    vl = logits.shape[-1]
    v0 = mesh.index("model") * vl
    m = C.all_reduce(logits.detach().amax(dim=-1).clone(), mesh, "model",
                     "max")
    se = C.all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1), mesh,
                      "model")
    t = targets.long() - v0
    inside = (t >= 0) & (t < vl)
    zt = torch.gather(logits, -1, torch.clamp(t, 0, vl - 1)[..., None])
    zt = C.all_reduce(torch.where(inside, zt[..., 0],
                                  torch.zeros_like(zt[..., 0])),
                      mesh, "model")
    return torch.log(se) + m - zt


def init_embedding(vocab, d, gen: torch.Generator, dtype):
    return _normal(gen, (vocab, d), dtype, 1.0 / math.sqrt(d)), \
        ("vocab", "embed")
