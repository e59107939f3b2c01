"""Decoder stack — forward, KV-cache decode and the sublayer chain the
LayerMerge host plans over.

The JAX package's ``models/transformer.py`` in PyTorch.  Params keep its
tree: ``{"groups": [stacked per layer group], "final_norm", "embed"[,
"unembed"]}``, each group's leaves carrying a leading layer axis, so a
params tree crosses between the packages as numpy arrays
(:func:`params_from_numpy` / :func:`params_to_numpy`).  Layers run in plain
Python loops (no scan, no remat).

Attention layers (``attn``, ``attn_local``) and RG-LRU layers
(``rglru``, :mod:`.rglru`) with a dense FFN are ported; the kinds ``moe``,
``mlstm`` and ``slstm`` raise ``NotImplementedError`` (ROADMAP.md queue
1).  Decode caches are a list of per-layer dicts: a KV cache
(:func:`repro_torch.models.layers.attention_decode`) or an RG-LRU state
``{"h", "conv"}``.  A decode step writes every state tensor in place and
reads nothing on the host (the position is a device tensor), so each
tensor keeps its storage from step to step and the step can be captured
in a CUDA graph and replayed.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..device import resolve
from . import layers as L
from . import rglru as RG
from .cnn import params_from_numpy, params_to_numpy

__all__ = ["GroupSpec", "layer_groups", "init_model", "model_axes",
           "forward", "init_cache", "decode_step", "sublayer_kinds",
           "sublayer_params", "params_from_numpy", "params_to_numpy"]

ATTN_KINDS = ("attn", "attn_local")
#: Temporal layer kinds the port runs.
TEMPORAL_KINDS = ATTN_KINDS + ("rglru",)


def check_config(cfg) -> None:
    """Raise unless the port runs every block of ``cfg``."""
    if cfg.is_moe:
        raise NotImplementedError(L._NOT_PORTED.format(what="MoE ('moe')"))
    for kind in sorted(set(cfg.layer_kinds())):
        if kind not in TEMPORAL_KINDS:
            raise NotImplementedError(
                L._NOT_PORTED.format(what=f"layer kind {kind!r}"))


# ---------------------------------------------------------------------------
# Layer groups
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupSpec:
    kind: str
    count: int
    start: int      # first layer index (0-based)


def layer_groups(cfg) -> tuple[GroupSpec, ...]:
    kinds = cfg.layer_kinds()
    groups = []
    i = 0
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        groups.append(GroupSpec(kind=kinds[i], count=j - i, start=i))
        i = j
    return tuple(groups)


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _stack_axes(ax):
    """Prepend the stacked ``layers`` axis to every logical-axes tuple of
    a (nested dict) axes tree; the tuples are the leaves."""
    if isinstance(ax, dict):
        return {k: _stack_axes(v) for k, v in ax.items()}
    return ("layers",) + tuple(ax)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(gp, i):
    """Layer ``i`` of a stacked group (views, no copies)."""
    return _tree_map(lambda t: t[i], gp)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(cfg, kind, gen, dtype):
    """One layer's params (``check_config`` has vetted ``kind``)."""
    n1, n1_ax = L.init_rmsnorm(cfg.d_model, dtype)
    p = {"norm1": n1}
    ax = {"norm1": n1_ax}
    p["temporal"], ax["temporal"] = (
        RG.init_rglru(cfg, gen, dtype) if kind == "rglru"
        else L.init_attention(cfg, gen, dtype))
    if cfg.has_ffn:
        n2, n2_ax = L.init_rmsnorm(cfg.d_model, dtype)
        p["norm2"] = n2
        ax["norm2"] = n2_ax
        p["ffn"], ax["ffn"] = L.init_ffn(cfg.d_model, cfg.d_ff, cfg.ffn_kind,
                                         gen, dtype)
    return p, ax


def _layer_axes(cfg, kind):
    ax = {"norm1": ("embed",),
          "temporal": RG.rglru_axes() if kind == "rglru"
          else L.attention_axes(cfg)}
    if cfg.has_ffn:
        ax["norm2"] = ("embed",)
        ax["ffn"] = L.ffn_axes(cfg.ffn_kind)
    return ax


def model_axes(cfg):
    """Logical-axes tree mirroring :func:`init_model`'s params."""
    check_config(cfg)
    axes = {"groups": [_stack_axes(_layer_axes(cfg, g.kind))
                       for g in layer_groups(cfg)],
            "final_norm": ("embed",)}
    if cfg.frontend == "tokens":
        axes["embed"] = ("vocab", "embed")
    if not cfg.tie_embeddings or cfg.frontend != "tokens":
        axes["unembed"] = ("embed", "vocab")
    return axes


def init_model(cfg, gen: torch.Generator | None = None, device="cuda"):
    """``(params, axes)``: weights drawn on the CPU from ``gen`` (a
    ``torch.Generator``; seed 0 by default), then moved to ``device`` (the
    card by default; raises without one)."""
    check_config(cfg)
    device = resolve(device)
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    dtype = _dtype(cfg)
    gparams = []
    for g in layer_groups(cfg):
        gparams.append(_stack([_init_layer(cfg, g.kind, gen, dtype)[0]
                               for _ in range(g.count)]))
    params = {"groups": gparams}
    params["final_norm"], _ = L.init_rmsnorm(cfg.d_model, dtype)
    if cfg.frontend == "tokens":
        params["embed"], _ = L.init_embedding(cfg.vocab_size, cfg.d_model,
                                              gen, dtype)
    if not cfg.tie_embeddings or cfg.frontend != "tokens":
        params["unembed"] = (torch.randn((cfg.d_model, cfg.vocab_size),
                                         generator=gen)
                             / math.sqrt(cfg.d_model)).to(dtype)
    return _tree_map(lambda t: t.to(device), params), model_axes(cfg)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def temporal_apply(cfg, kind, lp, h, positions):
    if kind == "rglru":
        return RG.rglru_block(lp, h, cfg)
    if kind not in ATTN_KINDS:
        raise NotImplementedError(
            L._NOT_PORTED.format(what=f"layer kind {kind!r}"))
    window = cfg.local_window if kind == "attn_local" else 0
    return L.attention(lp, h, cfg, positions, window=window)


def init_state(cfg, kind, batch_size, seq_len, device):
    """Zeroed decode state of one temporal layer: a KV cache (a ring
    buffer of ``local_window`` entries for ``attn_local``) or the RG-LRU
    state."""
    if kind == "rglru":
        return RG.init_rglru_state(cfg, batch_size, _dtype(cfg), device)
    if kind not in ATTN_KINDS:
        raise NotImplementedError(L._NOT_PORTED.format(
            what=f"decode state of {kind!r}"))
    return L.init_cache(cfg, batch_size, seq_len, _dtype(cfg),
                        window=cfg.local_window if kind == "attn_local"
                        else 0, device=device)


def temporal_decode(cfg, kind, lp, h, state):
    """One-token step of one temporal layer: ``(y, state)``, the KV cache
    or the RG-LRU state written in place (the same dict comes back)."""
    if kind == "rglru":
        return RG.rglru_decode(lp, h, cfg, state)
    window = cfg.local_window if kind == "attn_local" else 0
    return L.attention_decode(lp, h, cfg, state, window=window)


def _layer_fn(cfg, kind, positions, lp, x):
    h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
    x = x + temporal_apply(cfg, kind, lp["temporal"], h, positions)
    if cfg.has_ffn:
        h = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + L.ffn(lp["ffn"], h, cfg.ffn_kind)
    return x


def embed_in(cfg, params, batch):
    """``batch["tokens"]`` (B, S) through the embedding, or
    ``batch["embeds"]`` (B, S, D) as they are.  Token ids already on the
    table's device are read where they lie, not copied first."""
    if cfg.frontend == "tokens":
        table = params["embed"]
        tokens = torch.as_tensor(batch["tokens"], device=table.device)
        return table[tokens.long()]
    return torch.as_tensor(batch["embeds"]).to(_dtype(cfg))


def unembed(cfg, params, x):
    if cfg.tie_embeddings and cfg.frontend == "tokens":
        return x @ params["embed"].T
    return x @ params["unembed"]


def default_positions(x):
    return torch.arange(x.shape[1], device=x.device)[None, :]


def forward(cfg, params, batch):
    """Logits for prefill.  batch: ``tokens`` | ``embeds``[, ``positions``]."""
    check_config(cfg)
    x = embed_in(cfg, params, batch)
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(x)
    for g, gp in zip(layer_groups(cfg), params["groups"]):
        for i in range(g.count):
            x = _layer_fn(cfg, g.kind, positions, _layer(gp, i), x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x)


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size, seq_len, device="cuda"):
    """One decode state per layer (:func:`init_state`), in layer order, on
    ``device`` (the card by default; raises without one)."""
    check_config(cfg)
    device = resolve(device)
    return [init_state(cfg, kind, batch_size, seq_len, device)
            for kind in cfg.layer_kinds()]


def decode_step(cfg, params, cache, batch):
    """One-token decode: batch ``{'tokens': (B, 1)}`` → ``(logits, cache)``;
    every state tensor of the cache list is updated in place.  A KV
    cache's ``pos`` is 0-d or one position per row (the continuous
    engine's :func:`repro_torch.runtime.serving.stack_cache`)."""
    x = embed_in(cfg, params, batch)
    li = 0
    for g, gp in zip(layer_groups(cfg), params["groups"]):
        for i in range(g.count):
            lp = _layer(gp, i)
            h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
            t, cache[li] = temporal_decode(cfg, g.kind, lp["temporal"], h,
                                           cache[li])
            x = x + t
            if cfg.has_ffn:
                h = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
                x = x + L.ffn(lp["ffn"], h, cfg.ffn_kind)
            li += 1
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x), cache


# ---------------------------------------------------------------------------
# The sublayer chain LayerMerge plans over
# ---------------------------------------------------------------------------

def sublayer_kinds(cfg) -> tuple[str, ...]:
    """Flattened sublayer chain: temporal and FFN blocks interleaved —
    the 1-based layer indexing the compression plan refers to."""
    out = []
    for kind in cfg.layer_kinds():
        out.append(kind)
        if cfg.has_ffn:
            out.append("moe" if cfg.is_moe else "ffn")
    return tuple(out)


def sublayer_params(cfg, params):
    """Unstacked per-sublayer param list aligned with sublayer_kinds."""
    out = []
    for g, gp in zip(layer_groups(cfg), params["groups"]):
        for i in range(g.count):
            lp = _layer(gp, i)
            out.append({"norm": lp["norm1"], "p": lp["temporal"],
                        "kind": g.kind})
            if cfg.has_ffn:
                out.append({"norm": lp["norm2"], "p": lp["ffn"],
                            "kind": "moe" if cfg.is_moe else "ffn"})
    return out
