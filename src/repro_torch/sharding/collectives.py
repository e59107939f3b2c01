"""Explicit collectives of the mesh path, their gradients, and
flash-decoding.

The port's copy of the JAX package's ``sharding/collectives.py``.  Under
JAX a ``shard_map`` body names its collectives and GSPMD places the rest
(and transposes them for the backward pass); PyTorch has no such pass
over hand-written kernels, so every unit of the port's sharded loops
calls the collective its arithmetic needs, over the process group of a
:class:`~repro_torch.launch.mesh.HostMesh` axis, and each collective that
a loss is differentiated through is a ``torch.autograd.Function`` with
its conjugate as the backward (Megatron's pairs):

* :func:`all_reduce` — the sum after a row-parallel contraction (a
  split 'ffn', 'heads', 'rank' or 'vocab'); backward the identity.  Also
  the max of a split activation's ``amax`` (w8a8) and the (m, l, o)
  combine of flash-decoding, which no loss differentiates;
* :func:`enter_split` — a replicated activation entering a block whose
  weights are split (a column-parallel input: the attention and FFN
  inputs after the norm, the unembedding's input, the MoE's tokens):
  forward the identity, backward the sum of the ranks' partial
  gradients;
* :func:`all_gather` — where the next op needs a whole dimension (a
  dense conv's input channels, a vocab slice before the argmax, the
  batch blocks of an output); backward this rank's block of the
  (replicated) gradient;
* :func:`gather_weight` — a weight split over an axis whose ranks use
  it whole on different data (FSDP's 'embed' over 'data', the MoE
  router over 'model'): forward all-gather, backward
  :func:`reduce_scatter` (the sum of the ranks' gradients, this rank's
  block of it); :func:`gather_weights` does it for a layer's weights in
  one collective each way (FSDP's flat buffer);
* :func:`compressed_allreduce` — the int8 all-reduce of data-parallel
  gradients (:func:`repro_torch.optim.compress.compressed_psum`).

Nothing here copies a tensor to the host: each call hands the tensor,
where it lies, to ``torch.distributed`` (NCCL on the card; ``gloo``,
which also runs both on CUDA tensors, when ranks share a card).
A failed collective raises.  On a mesh without a process group (one
process, no ``init_process_group``) there is nothing to exchange and
each call returns its input.

Every call adds to :func:`collective_counts` (calls and bytes per
operation, this rank's payload); a collective issued by a backward pass
counts under its operation's name with ``:bwd`` appended, so a run can
report what a decode step or a train step exchanged each way
(:func:`collective_totals`).

* :func:`flash_decode_attention` — decode attention with the KV cache
  split along its *sequence* over 'model': each rank computes the
  partial softmax triple (o, l, m) over its cache slice; one
  ``all_reduce(MAX)`` of m and two ``all_reduce(SUM)``s of the rescaled o
  and l give the exact softmax, O(B·H·D) bytes instead of gathering the
  (B·S·KVH·D) cache.  :func:`flash_decode_reference` is the plain
  version.

* :func:`gpipe_forward` — GPipe's pipelined forward over a mesh axis
  (the stages), its activations passed stage to stage by point-to-point
  sends (counted as ``collective_permute``, the reference's
  ``ppermute``).
"""
from __future__ import annotations

import math

import torch

_COUNTS: dict[str, list[int]] = {}


def collective_counts() -> dict[str, dict[str, int]]:
    """Collectives issued in this process since the last reset: per
    operation, calls and bytes (the payload this rank handed in).  A
    backward pass's collectives are keyed ``<op>:bwd``."""
    return {k: {"calls": v[0], "bytes": v[1]} for k, v in _COUNTS.items()}


def collective_totals() -> dict[str, dict[str, int]]:
    """:func:`collective_counts` summed by direction: ``{"fwd": {calls,
    bytes}, "bwd": {calls, bytes}}``."""
    out = {"fwd": {"calls": 0, "bytes": 0}, "bwd": {"calls": 0, "bytes": 0}}
    for k, (calls, nbytes) in _COUNTS.items():
        d = out["bwd" if k.endswith(":bwd") else "fwd"]
        d["calls"] += calls
        d["bytes"] += nbytes
    return out


def reset_collective_counts() -> None:
    _COUNTS.clear()


def _count(op: str, t: torch.Tensor, bwd: bool = False) -> None:
    c = _COUNTS.setdefault(op + (":bwd" if bwd else ""), [0, 0])
    c[0] += 1
    c[1] += t.numel() * t.element_size()


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _group(mesh, axes):
    """(process group, size) of ``axes``; the group is None where the
    mesh has no process group (nothing to exchange)."""
    axes = _axes(axes)
    size = mesh.axis_size(axes)
    return mesh.group(axes), size


_OPS = {"sum": "SUM", "max": "MAX"}


def _reduce(t, mesh, axes, op: str, bwd: bool = False):
    """``t`` (contiguous, written in place) reduced over ``axes``."""
    import torch.distributed as dist

    group, _ = _group(mesh, axes)
    if group is None:
        return t
    _count(f"all_reduce_{op}", t, bwd)
    dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]), group=group)
    return t


def _gather(t, mesh, axes, dim: int, bwd: bool = False):
    import torch.distributed as dist

    group, size = _group(mesh, axes)
    if group is None:
        return t
    t = t.contiguous()
    _count("all_gather", t, bwd)
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _narrow_block(t, mesh, axes, dim: int):
    start, size = block(t.shape[dim], mesh, axes)
    return t.narrow(dim, start, size)


def reduce_scatter(t: torch.Tensor, mesh, axes, dim: int = 0, *,
                   bwd: bool = False):
    """The sum of ``t`` over the ranks of ``axes``, cut along ``dim`` into
    their blocks (the :class:`Placement` order): this rank's block."""
    import torch.distributed as dist

    group, size = _group(mesh, axes)
    if group is None:
        return t
    src = t.movedim(dim, 0).contiguous()
    _count("reduce_scatter", src, bwd)
    out = torch.empty((src.shape[0] // size, *src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    try:
        dist.reduce_scatter_tensor(out, src, group=group)
    except (RuntimeError, NotImplementedError):
        # a backend without reduce-scatter refuses before it exchanges
        dist.all_reduce(src, group=group)
        out = _narrow_block(src, mesh, axes, 0).contiguous()
    return out.movedim(0, dim)


def _grad_path(t) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _AllReduceSum(torch.autograd.Function):
    """Forward the sum over ``axes``; backward the identity."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        return _reduce(t.contiguous().clone(), mesh, axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _EnterSplit(torch.autograd.Function):
    """Forward the identity; backward the sum over ``axes``."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (_reduce(g.contiguous().clone(), ctx.mesh, ctx.axes, "sum",
                        bwd=True), None, None)


class _AllGather(torch.autograd.Function):
    """Forward the blocks concatenated along ``dim``; backward this
    rank's block of the gradient."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(t, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_narrow_block(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(),
                None, None, None)


def _gather_flat(blocks, dims, mesh, axes) -> tuple:
    """The blocks flattened into one buffer, all-gathered, and each
    leaf's rank blocks concatenated along its ``dims`` entry."""
    flat = torch.cat([b.reshape(-1) for b in blocks])
    parts = _gather(flat, mesh, axes, 0).chunk(_group(mesh, axes)[1])
    outs, o = [], 0
    for b, d in zip(blocks, dims):
        n = b.numel()
        outs.append(torch.cat([p[o:o + n].view(b.shape) for p in parts],
                              dim=d))
        o += n
    return tuple(outs)


class _GatherWeights(torch.autograd.Function):
    """Forward :func:`_gather_flat`: the blocks whole, in one collective;
    backward each gradient cut into its rank blocks, laid out rank by
    rank and reduce-scattered in one call."""

    @staticmethod
    def forward(ctx, mesh, axes, dims, *blocks):
        ctx.mesh, ctx.axes, ctx.dims = mesh, axes, dims
        ctx.shapes = [b.shape for b in blocks]
        return _gather_flat(blocks, dims, mesh, axes)

    @staticmethod
    def backward(ctx, *grads):
        size = _group(ctx.mesh, ctx.axes)[1]
        buf = torch.cat([g.narrow(d, r * s[d], s[d]).reshape(-1)
                         for r in range(size)
                         for g, d, s in zip(grads, ctx.dims, ctx.shapes)])
        mine = reduce_scatter(buf, ctx.mesh, ctx.axes, 0, bwd=True)
        out, o = [], 0
        for s in ctx.shapes:
            n = math.prod(s)
            out.append(mine[o:o + n].view(s))
            o += n
        return (None, None, None, *out)


def gather_weights(blocks, dims, mesh, axes) -> list:
    """:func:`gather_weight` of each block along its ``dims`` entry (one
    dtype), in one all-gather forward and one reduce-scatter backward:
    FSDP's flat buffer of a layer."""
    if _group(mesh, axes)[0] is None:
        return list(blocks)
    if any(_grad_path(b) for b in blocks):
        return list(_GatherWeights.apply(mesh, _axes(axes), tuple(dims),
                                         *blocks))
    return list(_gather_flat(blocks, dims, mesh, axes))


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum"):
    """``t`` reduced (``op``: 'sum' or 'max') over the ranks of ``axes``;
    returns the result.  Outside autograd it is written in place where
    ``t`` is contiguous; a sum that a loss is differentiated through
    takes a copy, and its gradient passes through unchanged (every rank
    holds the same sum, so each seeds the same cotangent)."""
    if _group(mesh, axes)[0] is None:
        return t
    if op == "sum" and _grad_path(t):
        return _AllReduceSum.apply(t, mesh, _axes(axes))
    return _reduce(t.contiguous(), mesh, axes, op)


def enter_split(t: torch.Tensor, mesh, axes="model"):
    """``t``, replicated over ``axes``, entering a block whose ranks each
    use it for their own shards: the identity forward (no collective), and
    its gradient summed over ``axes`` backward (each rank holds the
    partial its shards give)."""
    if _group(mesh, axes)[0] is None or not _grad_path(t):
        return t
    return _EnterSplit.apply(t, mesh, _axes(axes))


def all_gather(t: torch.Tensor, mesh, axes, dim: int = 0):
    """The blocks of ``t`` over the ranks of ``axes`` concatenated along
    ``dim``, in the axes' row-major order (the :class:`Placement` order).
    Backward: this rank's block of the gradient (the gathered tensor
    feeds the same computation on every rank)."""
    if _group(mesh, axes)[0] is None:
        return t
    if _grad_path(t):
        return _AllGather.apply(t, mesh, _axes(axes), dim)
    return _gather(t, mesh, axes, dim)


def gather_weight(t: torch.Tensor, mesh, axes, dim: int = 0):
    """A weight's blocks over ``axes`` gathered along ``dim`` for ranks
    that use it whole on different data: backward the gradient
    reduce-scattered back onto the blocks (FSDP, and the MoE router that
    each 'model' rank uses for its own experts)."""
    return gather_weights([t], [dim], mesh, axes)[0]


def compressed_allreduce(grads, *, mesh, axis: str = "data"):
    """int8 all-reduce of data-parallel gradients over ``axis``: each
    rank's tensors summed through
    :func:`repro_torch.optim.compress.compressed_psum`, the sum on every
    rank (the reference's ``shard_map`` over the blocks of ``axis``)."""
    from repro_torch.optim.compress import compressed_psum
    return compressed_psum(grads, mesh, axis)


def block(n: int, mesh, axes) -> tuple[int, int]:
    """``(start, size)`` of this rank's contiguous block of a dimension of
    ``n`` split over ``axes`` (the :class:`Placement` order)."""
    from .rules import Placement
    idx, count = Placement(mesh, (_axes(axes),))._block(0)
    return idx * (n // count), n // count


# ---------------------------------------------------------------------------
# Flash-decoding: distributed LSE combine over a sequence-split cache
# ---------------------------------------------------------------------------

def _local_partial(qg, k, v, valid, scale):
    """Partial attention over the local KV slice (GQA).

    qg: (B, KVH, G, D); k, v: (B, S_l, KVH, D); valid: (B, S_l) bool.
    Returns (o (B, KVH, G, D) unnormalized, l (B, KVH, G), m (B, KVH, G)).
    A fully masked slice has m = -1e30 and weight exp(-1e30 - m_global)
    = 0 in the combine, never NaN."""
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    s = torch.where(valid[:, None, None, :], s, -1e30)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o, l, m


def flash_decode_attention(q, k, v, valid, *, mesh, axis: str = "model"):
    """Exact decode attention over a KV cache split along its sequence.

    Every argument is this rank's local tensor: ``q`` (B, H, D) whole over
    ``axis`` (every head; the batch rows this rank holds: its block over
    the data axes, or all of them where those do not divide the batch,
    as the reference's ``bspec`` keeps them); ``k``, ``v`` (B, S_l, KVH,
    D) and ``valid`` (B, S_l) bool this rank's slice of the sequence.  H
    must be a multiple of KVH (query head h reads kv head h // (H/KVH)).
    Returns (B, H, D), the same on every rank of ``axis``."""
    b, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d)
    o, l, m = _local_partial(qg, k, v, valid, 1.0 / math.sqrt(d))
    g_m = all_reduce(m.clone(), mesh, axis, "max")
    corr = torch.exp(m - g_m)
    o = all_reduce(o * corr[..., None], mesh, axis, "sum")
    l = all_reduce(l * corr, mesh, axis, "sum")
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def flash_decode_reference(q, k, v, valid):
    """The plain version: masked softmax attention over the whole cache."""
    b, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                     k.float()) / math.sqrt(d)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v.float())
    return out.reshape(b, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# GPipe forward over an axis
# ---------------------------------------------------------------------------

def _rank_at(mesh, axis: str, index: int) -> int:
    """The global rank at this process's coordinates with ``axis`` at
    ``index``."""
    coords = dict(mesh.coords, **{axis: index})
    pos = 0
    for name in mesh.axis_names:
        pos = pos * mesh.shape[name] + coords[name]
    return mesh.ranks[pos]


def _shift(y: torch.Tensor, mesh, axis: str, idx: int, n: int):
    """``y`` sent to the next stage on ``axis`` (``idx + 1``) and the
    previous stage's tensor received (zeros on stage 0): one
    point-to-point pair a tick.  A ``gloo`` group moves a CUDA tensor
    through the host."""
    import torch.distributed as dist

    group = mesh.group(axis)
    staged = dist.get_backend(group) == "gloo" and y.is_cuda
    y = y.contiguous()
    send = y.cpu() if staged else y
    req = None
    if idx + 1 < n:
        _count("collective_permute", y)
        req = dist.isend(send, dst=_rank_at(mesh, axis, idx + 1),
                         group=group)
    buf = torch.zeros_like(send)
    if idx > 0:
        dist.recv(buf, src=_rank_at(mesh, axis, idx - 1), group=group)
    if req is not None:
        req.wait()
    return buf.to(y.device) if staged else buf


def gpipe_forward(stage_fn, stage_params, x, *, mesh, axis: str = "pod",
                  num_micro: int = 4):
    """Pipelined forward over ``axis`` (GPipe's schedule, the reference's
    ``gpipe_forward``): ``x`` (B, ...), replicated, is cut into
    ``num_micro`` microbatches; in each of ``num_micro + n_stage - 1``
    ticks stage 0 takes microbatch t (zeros once they are spent), every
    other stage the previous stage's last output, and each stage sends
    ``stage_fn(params, x_mb)`` to the next one.  The last stage's outputs
    of every microbatch are replicated over ``axis`` by a sum of the
    stages' outputs masked to the last (the reference's ``psum``), and
    returned in ``x``'s batch layout.

    ``stage_params``: this rank's block of a tree stacked on a leading
    stage axis (every leaf's leading dimension 1): its stage.  Forward
    only, as in the reference: nothing is differentiated."""
    from repro_torch.tree import tree_leaves, tree_map

    n = mesh.shape[axis]
    if x.shape[0] % num_micro:
        raise ValueError(f"batch {x.shape[0]} does not split into "
                         f"{num_micro} microbatches")
    if any(t.shape[0] != 1 for t in tree_leaves(stage_params)):
        raise ValueError("stage_params: this rank's block of the stage "
                         "axis, a leading dimension of 1 on every leaf")
    idx = mesh.index(axis)
    params = tree_map(lambda t: t[0], stage_params)
    mbs = x.reshape(num_micro, x.shape[0] // num_micro, *x.shape[1:])
    outs, buf = None, torch.zeros_like(mbs[0])
    with torch.no_grad():
        for t in range(num_micro + n - 1):
            if idx == 0:
                buf_in = mbs[t] if t < num_micro else torch.zeros_like(mbs[0])
            else:
                buf_in = buf
            y = stage_fn(params, buf_in)
            if outs is None:
                outs = torch.zeros((num_micro, *y.shape), dtype=y.dtype,
                                   device=y.device)
            if 0 <= t - (n - 1) < num_micro:
                outs[t - (n - 1)] = y
            if n > 1:
                buf = _shift(y, mesh, axis, idx, n)
        if idx != n - 1:
            outs.zero_()
        outs = all_reduce(outs, mesh, axis)
    return outs.reshape(x.shape[0], *outs.shape[2:])
