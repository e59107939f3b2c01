"""Decoder stack — forward, KV-cache decode and the sublayer chain the
LayerMerge host plans over.

The JAX package's ``models/transformer.py`` in PyTorch.  Params keep its
tree: ``{"groups": [stacked per layer group], "final_norm", "embed"[,
"unembed"]}``, each group's leaves carrying a leading layer axis, so a
params tree crosses between the packages as numpy arrays
(:func:`params_from_numpy` / :func:`params_to_numpy`).  Layers run in plain
Python loops (no scan, no remat).

Every block of the JAX package's stack is ported: attention layers
(``attn``, ``attn_local``; RoPE or M-RoPE), RG-LRU layers (``rglru``,
:mod:`.rglru`), xLSTM's ``mlstm`` and ``slstm`` (:mod:`.xlstm`), and a
dense FFN or an MoE FFN (:mod:`.moe`).  Decode caches are a list of
per-layer dicts: a KV cache
(:func:`repro_torch.models.layers.attention_decode`), an RG-LRU state
``{"h", "conv"}``, an mLSTM state ``{"C", "n", "m"}`` or an sLSTM state
``{"c", "n", "m"}``.  A decode step writes every state tensor in place
and reads nothing on the host (the position is a device tensor), so each
tensor keeps its storage from step to step and the step can be captured
in a CUDA graph and replayed.  A fresh state is not all zeros: the
xLSTM stabilizers start at ``-1e30``.

Under a mesh (:func:`repro_torch.sharding.rules.use_rules`) the same
functions run on this rank's shards: :func:`forward` and
:func:`decode_step` take the batch's rows of the rank's data block
(:func:`local_batch`), each layer sums the partial its blocks return over
'model' (:func:`reduce_partial`), and the logits are gathered back to the
whole batch and vocab (:func:`gather_rows`), so the caller sees the
single-device shapes.  A decode step follows its cache: a cache built
with every row (the continuous engine's widened batch-1 state) is served
whole on every rank.  Weights that FSDP rules split over the data axes
('embed', ``make_rules(fsdp=True)``) are gathered whole layer by layer as
they are used (:func:`_layer`), their gradients reduce-scattered back.

The LayerMerge-compressed forward (:func:`forward_compressed`, the JAX
package's legacy tuple units) runs a plan's chain: kept sublayers
(:func:`sublayer_apply`) and merged rank-r residual maps through the
``merged_ffn`` kernel (:func:`merged_residual`), under a mesh with the
conjugate collectives of the unit graph's executor.  :func:`cache_axes`
gives the JAX package's stacked cache axes for the dry run.

Training: :func:`lm_loss` is the causal LM cross-entropy (fp32
log-softmax, an optional ``loss_mask``) over :func:`upcast_for_loss`'s
fp32 view of the logits, whose cotangent keeps the logits' dtype
(:mod:`repro_torch.train.step` differentiates it).  Under a mesh each
rank takes the loss of its own rows (:func:`forward_local`, no logits
gathered) and every collective on the way carries its gradient
(:mod:`repro_torch.sharding.collectives`).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import kernels
from ..device import draw_device, drawing_on, resolve
from ..sharding import collectives as C
from ..sharding.rules import (active_rules, data_axes, gather_data_split,
                              sharding_of)
from ..tree import flatten_tree, tree_map, tree_map_with_path
from . import layers as L
from . import moe as MOE
from . import rglru as RG
from . import xlstm as XL
from .cnn import params_from_numpy, params_to_numpy

__all__ = ["GroupSpec", "layer_groups", "init_model", "model_axes",
           "forward", "forward_local", "upcast_for_loss", "lm_loss",
           "local_loss", "token_nll", "init_cache", "cache_axes",
           "decode_step", "sublayer_kinds", "sublayer_params",
           "forward_compressed", "forward_compressed_local",
           "params_from_numpy", "params_to_numpy"]

ATTN_KINDS = ("attn", "attn_local")
#: Temporal layer kinds of the stack.
TEMPORAL_KINDS = ATTN_KINDS + ("rglru", "mlstm", "slstm")


def check_config(cfg) -> None:
    """Raise on a temporal layer kind the stack does not know."""
    for kind in sorted(set(cfg.layer_kinds())):
        if kind not in TEMPORAL_KINDS:
            raise ValueError(f"unknown layer kind {kind!r}; the stack has "
                             f"{TEMPORAL_KINDS}")


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


def _stack_axes(ax):
    """Prepend the stacked ``layers`` axis to every logical-axes tuple of
    a (nested dict) axes tree; the tuples are the leaves."""
    if isinstance(ax, dict):
        return {k: _stack_axes(v) for k, v in ax.items()}
    return ("layers",) + tuple(ax)


def _empty_stack(tree, n: int, device):
    """Uninitialised tensors on ``device`` shaped like ``tree``'s leaves
    with a leading axis of ``n`` (the dict's key order kept)."""
    if isinstance(tree, dict):
        return {k: _empty_stack(v, n, device) for k, v in tree.items()}
    return torch.empty((n, *tree.shape), dtype=tree.dtype, device=device)


def _put(stacked, tree, i: int) -> None:
    """Copy ``tree``'s leaves into slot ``i`` of ``stacked``'s."""
    if isinstance(stacked, dict):
        for k, v in stacked.items():
            _put(v, tree[k], i)
    else:
        stacked[i].copy_(tree)


def _layer(gp, i):
    """Layer ``i`` of a stacked group (views, no copies); under FSDP
    rules the leaves' dimensions split over the data axes are gathered
    whole, the layer's in one collective
    (:func:`repro_torch.sharding.rules.gather_data_split`)."""
    if active_rules() is None:
        return tree_map(lambda t: t[i], gp)
    whole = gather_data_split({k: (t[i], sharding_of(t))
                               for k, t in flatten_tree(gp).items()}, 1)
    return tree_map_with_path(lambda k, _: whole[k], gp)


def _whole_top(params):
    """``params`` with its leaves outside the layer groups (embedding,
    unembedding, final norm) gathered whole over the data axes where
    FSDP split them: one gather, shared by every use."""
    if active_rules() is None:
        return params
    return {**params, **whole_over_data({
        k: v for k, v in params.items() if k not in ("groups", "units")})}


def whole_over_data(tree):
    """``tree`` (a unit's params) with every dimension FSDP split over
    the data axes gathered whole, one collective a bucket each way;
    ``tree`` itself outside a mesh or where nothing is split there."""
    if active_rules() is None:
        return tree
    whole = gather_data_split({k: (t, sharding_of(t)) for k, t in
                               flatten_tree(tree).items()})
    return tree_map_with_path(lambda k, _: whole[k], tree)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_temporal(cfg, kind, gen, dtype):
    if kind == "rglru":
        return RG.init_rglru(cfg, gen, dtype)
    if kind == "mlstm":
        return XL.init_mlstm(cfg, gen, dtype)
    if kind == "slstm":
        return XL.init_slstm(cfg, gen, dtype)
    return L.init_attention(cfg, gen, dtype)


def temporal_axes(cfg, kind):
    """Logical axes of one temporal block's params."""
    if kind == "rglru":
        return RG.rglru_axes()
    if kind == "mlstm":
        return XL.mlstm_axes()
    if kind == "slstm":
        return XL.slstm_axes()
    return L.attention_axes(cfg)


def _init_layer(cfg, kind, gen, dtype):
    """One layer's params (``check_config`` has vetted ``kind``)."""
    n1, n1_ax = L.init_rmsnorm(cfg.d_model, dtype)
    p = {"norm1": n1}
    ax = {"norm1": n1_ax}
    p["temporal"], ax["temporal"] = _init_temporal(cfg, kind, gen, dtype)
    if cfg.has_ffn:
        n2, n2_ax = L.init_rmsnorm(cfg.d_model, dtype)
        p["norm2"] = n2
        ax["norm2"] = n2_ax
        p["ffn"], ax["ffn"] = (
            MOE.init_moe(cfg, gen, dtype) if cfg.is_moe
            else L.init_ffn(cfg.d_model, cfg.d_ff, cfg.ffn_kind, gen, dtype))
    return p, ax


def _layer_axes(cfg, kind):
    ax = {"norm1": ("embed",), "temporal": temporal_axes(cfg, kind)}
    if cfg.has_ffn:
        ax["norm2"] = ("embed",)
        ax["ffn"] = MOE.moe_axes() if cfg.is_moe else L.ffn_axes(
            cfg.ffn_kind)
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
    """``(params, axes)``: weights drawn from ``gen`` (a ``torch.Generator``;
    a CPU one at seed 0 by default) on the generator's device, layer by
    layer, each layer copied into its group's stacked tensors, which are
    allocated once on ``device`` (the card by default; raises without
    one): no device holds two copies of the weights.  A generator on the
    card draws there, in seconds for a 7B config where the CPU takes
    minutes; it gives other values than a CPU generator of the same
    seed.  A CPU generator's draws do not depend on ``device``.  On
    ``"meta"`` nothing is drawn or allocated: the tree of shapes and
    dtypes (the dry run's parameters)."""
    check_config(cfg)
    device = resolve(device)
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    if device.type == "meta":
        with drawing_on(device):
            return _init_model(cfg, gen, device)
    return _init_model(cfg, gen, device)


def _init_model(cfg, gen, device):
    dtype = _dtype(cfg)
    gparams = []
    for g in layer_groups(cfg):
        stacked = None
        for i in range(g.count):
            lp = _init_layer(cfg, g.kind, gen, dtype)[0]
            if stacked is None:
                stacked = _empty_stack(lp, g.count, device)
            _put(stacked, lp, i)
            del lp
        gparams.append(stacked)
    params = {"groups": gparams}
    params["final_norm"], _ = L.init_rmsnorm(cfg.d_model, dtype)
    if cfg.frontend == "tokens":
        params["embed"], _ = L.init_embedding(cfg.vocab_size, cfg.d_model,
                                              gen, dtype)
    if not cfg.tie_embeddings or cfg.frontend != "tokens":
        params["unembed"] = (torch.randn((cfg.d_model, cfg.vocab_size),
                                         generator=gen,
                                         device=draw_device(gen))
                             / math.sqrt(cfg.d_model)).to(dtype)
    # the tree in sorted key order (as tree_map builds it), the stacked
    # leaves as they are
    return tree_map(lambda t: t.to(device), params), model_axes(cfg)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def temporal_apply(cfg, kind, lp, h, positions, mrope_positions=None):
    """One temporal block's prefill output (a partial over 'model' where
    :func:`block_partial` says so)."""
    if kind == "rglru":
        return RG.rglru_block(lp, h, cfg)
    if kind == "mlstm":
        return XL.mlstm_block(lp, h, cfg)
    if kind == "slstm":
        return XL.slstm_block(lp, h, cfg)
    if kind not in ATTN_KINDS:
        raise ValueError(f"unknown layer kind {kind!r}")
    window = cfg.local_window if kind == "attn_local" else 0
    return L.attention(lp, h, cfg, positions, window=window,
                       mrope_positions=mrope_positions)


def block_partial(cfg, kind, p) -> bool:
    """Whether block ``kind`` on these (local) weights returns a partial
    sum over 'model': its output projection contracts a split dimension
    (the heads, the FFN or recurrence width).  The mLSTM block sums its
    own (its skip path is whole) and the MoE block its token outputs."""
    if kind in ATTN_KINDS:
        return L.attention_partial(p, cfg)
    if kind == "rglru":
        return RG.rglru_partial(p, cfg)
    if kind == "slstm":
        return XL.xlstm_partial(p, cfg)
    if kind == "ffn":
        return L.ffn_partial(p, cfg)
    return False


def reduce_partial(cfg, kind, p, t):
    """``t`` summed over 'model' where it is a partial, else ``t``."""
    if block_partial(cfg, kind, p):
        return C.all_reduce(t, active_rules().mesh, "model")
    return t


#: Batch entries with a leading batch axis, cut to a rank's rows.
BATCH_KEYS = ("tokens", "embeds", "positions", "targets", "loss_mask")


def local_batch(batch, rows: int | None = None):
    """``(batch, axes)``: this rank's rows of ``batch`` and the data axes
    they are a block of, or ``(batch, None)`` where the batch stays whole
    (no mesh, or axes that do not divide it, or ``rows`` — the rows of
    the decode cache — equal to the whole batch).  A batch that is
    already a block (its ids carry a placement split on the batch axis:
    :class:`repro_torch.data.pipeline.GlobalBatcher` under a mesh) is
    returned as it is, with its axes."""
    r = active_rules()
    if r is None:
        return batch, None
    key = "tokens" if "tokens" in batch else "embeds"
    place = sharding_of(batch[key])
    if place is not None and place.is_split(0):
        return batch, place.spec[0]
    n = len(batch[key])
    part = r.spec(("batch",), (n,))[0]
    if part is None or rows == n:
        return batch, None
    start, size = C.block(n, r.mesh, part)
    out = dict(batch)
    for k in BATCH_KEYS:
        if out.get(k) is not None and len(out[k]) == n:
            out[k] = out[k][start:start + size]
    if out.get("mrope_positions") is not None:
        out["mrope_positions"] = out["mrope_positions"][:, start:start + size]
    return out, part


def gather_rows(t, part):
    """The whole batch of ``t`` (dim 0) from its blocks over ``part``."""
    if part is None:
        return t
    return C.all_gather(t, active_rules().mesh, part, dim=0)


def sublayer_apply(cfg, kind, p, h, positions=None, mrope_positions=None):
    """One kept sublayer's block (``kind`` of :func:`sublayer_kinds`) on
    its normed input ``h``: a temporal block, the dense FFN or the MoE
    FFN at the config's capacity factor, summed over 'model' where it
    returns a partial (:func:`reduce_partial`)."""
    if kind == "moe":
        t = MOE.moe_dispatch(p, h, cfg, capacity_factor=cfg.capacity_factor)
    elif kind == "ffn":
        t = L.ffn(p, split_input(cfg, "ffn", p, h), cfg.ffn_kind)
    else:
        t = temporal_apply(cfg, kind, p, h, positions, mrope_positions)
    return reduce_partial(cfg, kind, p, t)


def merged_residual(p, x, **kw):
    """A merged unit's rank-r residual map ``x + (x·U)·V`` through the
    ``merged_ffn`` kernel (:func:`repro_torch.kernels.merged_ffn_op`, its
    plain version off the card): ``p`` holds ``u`` and ``v`` (and the
    ``u_scale`` / ``v_scale`` of narrow factors; ``kw`` the op's
    ``act_quant`` and ``reduce_amax``).  Under a mesh that splits 'rank'
    over 'model' each rank holds ``U[:, r]`` and ``V[r, :]``: ``x``,
    replicated, enters the split product (its gradient summed over
    'model'), 'model' rank 0 alone adds the residual (forward, and
    through the kernel's gradient backward) and the outputs are summed,
    their gradient passed through.  FSDP's data blocks of the factors
    are gathered first (their gradients reduce-scattered back)."""
    place = sharding_of(p["u"])
    split = active_rules() is not None and place is not None \
        and place.is_split(1)
    w = whole_over_data(p)
    args = (w["u"], w["v"])
    kw = dict(kw, u_scale=w.get("u_scale"), v_scale=w.get("v_scale"))
    if not split:
        return kernels.merged_ffn_op(x, *args, **kw)
    mesh = active_rules().mesh
    y = kernels.merged_ffn_op(C.enter_split(x, mesh, "model"), *args,
                              residual=mesh.index("model") == 0, **kw)
    return C.all_reduce(y, mesh, "model")


def split_input(cfg, kind, p, h):
    """``h``, replicated over 'model', entering block ``kind`` whose
    weights are split there (:func:`block_partial`): its gradient is the
    sum of the ranks' partials
    (:func:`repro_torch.sharding.collectives.enter_split`); ``h`` as it
    is where the block is whole."""
    if not block_partial(cfg, kind, p):
        return h
    return C.enter_split(h, active_rules().mesh, "model")


def init_state(cfg, kind, batch_size, seq_len, device):
    """Fresh decode state of one temporal layer: a zeroed KV cache (a ring
    buffer of ``local_window`` entries for ``attn_local``), the zeroed
    RG-LRU state, or an xLSTM state (its stabilizer at ``-1e30``)."""
    if kind == "rglru":
        return RG.init_rglru_state(cfg, batch_size, _dtype(cfg), device)
    if kind == "mlstm":
        return XL.init_mlstm_state(cfg, batch_size, device)
    if kind == "slstm":
        return XL.init_slstm_state(cfg, batch_size, device)
    if kind not in ATTN_KINDS:
        raise ValueError(f"unknown layer kind {kind!r}")
    return L.init_cache(cfg, batch_size, seq_len, _dtype(cfg),
                        window=cfg.local_window if kind == "attn_local"
                        else 0, device=device)


def temporal_decode(cfg, kind, lp, h, state, mrope_positions=None):
    """One-token step of one temporal layer: ``(y, state)``, the state
    written in place (the same dict comes back)."""
    if kind == "rglru":
        return RG.rglru_decode(lp, h, cfg, state)
    if kind == "mlstm":
        return XL.mlstm_decode(lp, h, cfg, state)
    if kind == "slstm":
        return XL.slstm_decode(lp, h, cfg, state)
    window = cfg.local_window if kind == "attn_local" else 0
    return L.attention_decode(lp, h, cfg, state, window=window,
                              mrope_positions=mrope_positions)


def _ffn_kind(cfg) -> str:
    return "moe" if cfg.is_moe else "ffn"


def _layer_fn(cfg, kind, positions, mrope, lp, x):
    h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
    # attention, RG-LRU and the xLSTM blocks take their split input
    # themselves (the mLSTM's skip path uses it whole)
    x = x + sublayer_apply(cfg, kind, lp["temporal"], h, positions, mrope)
    if cfg.has_ffn:
        h = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + sublayer_apply(cfg, _ffn_kind(cfg), lp["ffn"], h)
    return x


def embed_in(cfg, params, batch):
    """``batch["tokens"]`` (B, S) through the embedding (a vocab slice of
    it under a mesh, :func:`repro_torch.models.layers.embed`), or
    ``batch["embeds"]`` (B, S, D) as they are, on the params' device.
    Token ids already on the table's device are read where they lie, not
    copied first."""
    if cfg.frontend == "tokens":
        table = params["embed"]
        tokens = torch.as_tensor(batch["tokens"], device=table.device)
        return L.embed(table, tokens, cfg.vocab_size)
    return torch.as_tensor(batch["embeds"],
                           device=params["final_norm"].device).to(_dtype(cfg))


def unembed(cfg, params, x, gather: bool = True):
    """Logits of the whole vocab (its slices gathered under a mesh; this
    rank's slice with ``gather=False``)."""
    w = params["embed"].T if cfg.tie_embeddings and cfg.frontend == "tokens" \
        else params["unembed"]
    return L.unembed_logits(x, w, cfg.vocab_size, gather)


def default_positions(x):
    return torch.arange(x.shape[1], device=x.device)[None, :]


def mrope_of(batch, x):
    """``batch["mrope_positions"]`` (3, B, S) on ``x``'s device, or None."""
    m = batch.get("mrope_positions")
    return None if m is None else torch.as_tensor(m, device=x.device)


def forward(cfg, params, batch):
    """Logits for prefill.  batch: ``tokens`` | ``embeds``[,
    ``positions``][, ``mrope_positions`` (3, B, S)]."""
    logits, _, part = forward_local(cfg, params, batch)
    return gather_rows(logits, part)


def forward_local(cfg, params, batch, gather_vocab: bool = True):
    """``(logits of this rank's rows, its rows of the batch, the data
    axes they are a block of or None)``: :func:`forward` before the rows
    are gathered (and with ``gather_vocab=False`` before the vocab slices
    are: this rank's slice)."""
    check_config(cfg)
    batch, part = local_batch(batch)
    params = _whole_top(params)
    x = embed_in(cfg, params, batch)
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(x)
    mrope = mrope_of(batch, x)
    for g, gp in zip(layer_groups(cfg), params["groups"]):
        for i in range(g.count):
            x = _layer_fn(cfg, g.kind, positions, mrope, _layer(gp, i), x)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x, gather_vocab), batch, part


class _UpcastForLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def upcast_for_loss(x):
    """fp32 view of low-precision logits whose cotangent keeps the
    logits' dtype: the fp32 loss does not promote the whole backward to
    fp32.  fp32 logits come back as they are."""
    if x.dtype == torch.float32:
        return x
    return _UpcastForLoss.apply(x)


def token_nll(logits, targets):
    """(B, S) negative log-likelihood of ``targets`` under fp32 logits
    (B, S, V): the log-softmax in fp32."""
    targets = torch.as_tensor(targets, device=logits.device).long()
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None])[..., 0]


def lm_loss(cfg, params, batch):
    """Causal LM cross-entropy: the mean over tokens of the fp32
    log-softmax NLL of ``batch["targets"]`` (B, S), or its mean over the
    tokens where ``batch["loss_mask"]`` is set.

    Under a mesh the NLL of a vocab split over 'model' comes from each
    rank's slice (:func:`repro_torch.models.layers.vocab_parallel_nll`),
    and under rules whose data axes are larger than 1 each rank takes the
    NLL of its own rows only (no logits are gathered): its share of the
    global loss, the sum of its tokens' NLL over the global count (the
    batch's tokens, or the mask's, summed over the data axes), or the
    global loss over the data size where the batch stays whole.  The
    shares are summed over the data axes (an all-reduce whose gradient
    passes through), so every rank returns the global loss and each
    rank's gradients are its share's: the train step sums them over the
    data axes (:mod:`repro_torch.train.step`)."""
    return local_loss(cfg, *forward_local(cfg, params, batch,
                                          gather_vocab=False))


def local_loss(cfg, logits, batch, part, use_mask: bool = True):
    """:func:`lm_loss` from this rank's logits (its rows; its vocab slice
    under a mesh that splits the vocab), its rows of the batch and the
    data axes they are a block of (:func:`forward_local`'s triple).
    ``use_mask=False`` ignores ``batch["loss_mask"]`` (the mean over every
    token, as the reference's loss of a compressed forward takes it)."""
    logits = upcast_for_loss(logits)
    if logits.shape[-1] < cfg.vocab_size:           # this rank's slice
        nll = L.vocab_parallel_nll(logits, torch.as_tensor(
            batch["targets"], device=logits.device))
    else:
        nll = token_nll(logits, batch["targets"])
    mask = batch.get("loss_mask") if use_mask else None
    if mask is not None:
        mask = torch.as_tensor(mask, device=nll.device).to(torch.float32)
    r = active_rules()
    daxes = data_axes(r) if r is not None else ()
    if not daxes or part is None:
        if mask is not None:
            loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask),
                                                       min=1.0)
        else:
            loss = torch.mean(nll)
        if not daxes:
            return loss
        loss = loss / r.mesh.axis_size(daxes)
    elif mask is not None:
        count = C.all_reduce(torch.sum(mask).detach().clone(), r.mesh, part)
        loss = torch.sum(nll * mask) / torch.clamp(count, min=1.0)
    else:
        loss = torch.sum(nll) / float(nll.numel() * r.mesh.axis_size(part))
    return C.all_reduce(loss, r.mesh, daxes)


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
    """One-token decode: batch ``{'tokens': (B, 1)}`` (or ``'embeds'``
    (B, 1, D))[, ``mrope_positions`` (3, B, 1)] → ``(logits, cache)``;
    every state tensor of the cache list is updated in place.  A KV
    cache's ``pos`` is 0-d or one position per row (the continuous
    engine's :func:`repro_torch.runtime.serving.stack_cache`)."""
    batch, part = local_batch(batch, cache_rows(cache))
    params = _whole_top(params)
    x = embed_in(cfg, params, batch)
    mrope = mrope_of(batch, x)
    li = 0
    for g, gp in zip(layer_groups(cfg), params["groups"]):
        for i in range(g.count):
            lp = _layer(gp, i)
            h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
            t, cache[li] = temporal_decode(cfg, g.kind, lp["temporal"], h,
                                           cache[li], mrope)
            x = x + reduce_partial(cfg, g.kind, lp["temporal"], t)
            if cfg.has_ffn:
                h = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
                x = x + sublayer_apply(cfg, _ffn_kind(cfg), lp["ffn"], h)
            li += 1
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return gather_rows(unembed(cfg, params, x), part), cache


def cache_rows(cache) -> int | None:
    """The batch rows a decode state holds (the first state tensor with a
    batch axis), or None for a state with no tensor."""
    for st in cache:
        for v in st.values():
            if isinstance(v, torch.Tensor) and v.ndim >= 1:
                return v.shape[0]
    return None


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


def cache_axes(cfg):
    """Logical axes of the JAX package's decode cache, one dict per layer
    group with the stacked ``layers`` axis first (its ``cache_axes``,
    for the dry run's shardings).  The port's cache is one state per
    layer (:func:`init_cache`): layer ``i`` of a group takes the group's
    axes without their first entry."""
    out = []
    for g in layer_groups(cfg):
        if g.kind in ATTN_KINDS:
            ax = dict(L.CACHE_AXES)
        elif g.kind == "rglru":
            ax = dict(RG.RGLRU_STATE_AXES)
        elif g.kind == "mlstm":
            ax = dict(XL.MLSTM_STATE_AXES)
        elif g.kind == "slstm":
            ax = dict(XL.SLSTM_STATE_AXES)
        else:
            ax = {}
        out.append({k: ("layers",) + tuple(a) for k, a in ax.items()})
    return out


# ---------------------------------------------------------------------------
# The LayerMerge-compressed forward (plan-aware)
# ---------------------------------------------------------------------------

def _apply_compressed_unit(cfg, unit, x, positions, mrope_positions=None):
    """One unit of :func:`forward_compressed`'s list on the stream ``x``."""
    if unit[0] == "skip":
        return x
    if unit[0] == "merged":
        u, v = unit[1]
        return merged_residual({"u": u, "v": v}, x)
    sub = unit[1]
    p = whole_over_data({"norm": sub["norm"], "p": sub["p"]})
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    return x + sublayer_apply(cfg, sub["kind"], p["p"], h, positions,
                              mrope_positions)


def forward_compressed_local(cfg, params, units, batch,
                             gather_vocab: bool = True):
    """:func:`forward_compressed` before the rows (and, with
    ``gather_vocab=False``, the vocab slices) are gathered: ``(logits of
    this rank's rows, its rows of the batch, the data axes they are a
    block of or None)``, as :func:`forward_local`."""
    check_config(cfg)
    batch, part = local_batch(batch)
    params = _whole_top(params)
    x = embed_in(cfg, params, batch)
    positions = batch.get("positions")
    if positions is None:
        positions = default_positions(x)
    mrope = mrope_of(batch, x)
    for unit in units:
        x = _apply_compressed_unit(cfg, unit, x, positions, mrope)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x, gather_vocab), batch, part


def forward_compressed(cfg, params, units, batch):
    """Logits of a LayerMerge-compressed stack: ``params`` holds the
    embedding, final norm (and unembedding), ``units`` the chain built
    from a plan (the JAX package's legacy tuple form): ``('orig', sub)``
    with ``sub = {"norm", "p", "kind"}`` a kept sublayer, ``('merged',
    (u, v))`` a rank-r residual map through the ``merged_ffn`` kernel,
    ``('skip',)`` nothing.  Under a mesh it runs on this rank's shards
    and returns the single-device shapes, as :func:`forward`."""
    logits, _, part = forward_compressed_local(cfg, params, units, batch)
    return gather_rows(logits, part)
