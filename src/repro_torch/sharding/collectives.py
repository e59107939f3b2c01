"""Explicit collectives of the mesh path, and flash-decoding.

The port's copy of the JAX package's ``sharding/collectives.py``.  Under
JAX a ``shard_map`` body names its collectives and GSPMD places the rest;
PyTorch has no such pass over hand-written kernels, so every unit of the
port's sharded loops calls the collective its arithmetic needs, over the
process group of a :class:`~repro_torch.launch.mesh.HostMesh` axis:

* :func:`all_reduce` — the sum after a row-parallel contraction (a
  split 'ffn', 'heads', 'rank' or 'vocab'), the max of a split
  activation's ``amax`` (w8a8), and the (m, l, o) combine of
  flash-decoding;
* :func:`all_gather` — where the next op needs a whole dimension (a
  dense conv's input channels, a vocab slice before the argmax, the
  batch blocks of an output).

Nothing here copies a tensor to the host: each call hands the tensor,
where it lies, to ``torch.distributed`` (NCCL on the card; ``gloo``,
which also runs both on CUDA tensors, when ranks share a card).
A failed collective raises.  On a mesh without a process group (one
process, no ``init_process_group``) there is nothing to exchange and
each call returns its input.

Every call adds to :func:`collective_counts` (calls and bytes per
operation, this rank's payload), so a run can report what a decode step
exchanged.

* :func:`flash_decode_attention` — decode attention with the KV cache
  split along its *sequence* over 'model': each rank computes the
  partial softmax triple (o, l, m) over its cache slice; one
  ``all_reduce(MAX)`` of m and two ``all_reduce(SUM)``s of the rescaled o
  and l give the exact softmax, O(B·H·D) bytes instead of gathering the
  (B·S·KVH·D) cache.  :func:`flash_decode_reference` is the plain
  version.

``gpipe_forward`` and ``compressed_allreduce`` belong to the training
and dry-run slice (ROADMAP.md queue 1 item 5b, steps 1 and 4).
"""
from __future__ import annotations

import math

import torch

_COUNTS: dict[str, list[int]] = {}


def collective_counts() -> dict[str, dict[str, int]]:
    """Collectives issued in this process since the last reset: per
    operation, calls and bytes (the payload this rank handed in)."""
    return {k: {"calls": v[0], "bytes": v[1]} for k, v in _COUNTS.items()}


def reset_collective_counts() -> None:
    _COUNTS.clear()


def _count(op: str, t: torch.Tensor) -> None:
    c = _COUNTS.setdefault(op, [0, 0])
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


def all_reduce(t: torch.Tensor, mesh, axes, op: str = "sum"):
    """``t`` reduced (``op``: 'sum' or 'max') over the ranks of ``axes``,
    in place where ``t`` is contiguous; returns the result."""
    import torch.distributed as dist

    group, _ = _group(mesh, axes)
    if group is None:
        return t
    t = t.contiguous()
    _count(f"all_reduce_{op}", t)
    dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]), group=group)
    return t


def all_gather(t: torch.Tensor, mesh, axes, dim: int = 0):
    """The blocks of ``t`` over the ranks of ``axes`` concatenated along
    ``dim``, in the axes' row-major order (the :class:`Placement` order)."""
    import torch.distributed as dist

    group, size = _group(mesh, axes)
    if group is None:
        return t
    t = t.contiguous()
    _count("all_gather", t)
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


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
