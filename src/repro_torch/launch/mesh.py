"""Host meshes: the ranks of a ``torch.distributed`` job as a named grid.

The port's copy of the JAX package's ``launch/mesh.py``
(``make_production_mesh``, ``make_host_mesh``, ``mesh_info``).  Where JAX lays devices out in a
``jax.sharding.Mesh`` and XLA places every collective, here a rank is one
process (one card, or the CPU) and a :class:`HostMesh` is a row-major
grid of the default process group's ranks with named axes, one process
group per set of axes: the groups the explicit collectives of
:mod:`repro_torch.sharding.collectives` run over.  The sharding rules
(:mod:`repro_torch.sharding.rules`) read only ``mesh.shape``.

A process with no process group has the one-rank mesh: every axis of
size 1 and no group, so a collective over it has nothing to exchange and
returns its input.  A job with a group issues every collective, whatever
the size of the group, so a one-rank NCCL mesh runs (and a CUDA graph
captures) the same code as a wide one.

:func:`make_production_mesh` is the dry run's: the reference's 16 × 16
('data', 'model') grid of one pod, or 2 × 16 × 16 with 'pod', over a
process group of that many ranks (a fake one,
:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

import itertools
import math


class HostMesh:
    """A grid of ranks with named axes.

    ``shape``: axis name → size, in axis order; ``ranks``: the global
    ranks in row-major grid order (the JAX package's
    ``mesh.devices.flat``).  ``coords`` is this process's position (axis
    name → index), None where the process is not in the mesh (a rank
    :func:`~repro_torch.launch.distributed.survivor_mesh` dropped).
    ``group(axes)`` is the process group of the ranks that share this
    process's coordinates on every other axis (None without a process
    group)."""

    def __init__(self, shape: dict, ranks, rank: int | None, groups: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.ranks = tuple(ranks)
        self.rank = rank
        self._groups = groups
        self.coords = None
        if rank is not None and rank in self.ranks:
            pos = self.ranks.index(rank)
            coords = {}
            for name in reversed(self.axis_names):
                pos, coords[name] = divmod(pos, self.shape[name])
            self.coords = {n: coords[n] for n in self.axis_names}

    def index(self, axis: str) -> int:
        """This process's index on ``axis`` (0 on an axis the mesh lacks)."""
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} is not in this mesh "
                               f"(ranks {list(self.ranks)})")
        return self.coords.get(axis, 0)

    def axis_size(self, axes) -> int:
        """Product of the sizes of ``axes`` (a name or a tuple; axes the
        mesh lacks count 1)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def group(self, axes):
        """The process group over ``axes`` (a name or a tuple) that holds
        this process, or None where there is no process group."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = frozenset(a for a in axes if a in self.shape)
        if not key:
            return None
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} is not in this mesh")
        return self._groups.get((key, self._coset(key)))

    def _coset(self, key) -> tuple:
        return tuple(self.coords[n] for n in self.axis_names if n not in key)

    def __repr__(self) -> str:
        return f"HostMesh({self.shape}, ranks={list(self.ranks)})"


def _axis_sets(names):
    for k in range(1, len(names) + 1):
        yield from itertools.combinations(names, k)


def build_mesh(shape: dict, ranks) -> HostMesh:
    """A :class:`HostMesh` of ``shape`` over the global ``ranks``, with its
    process groups.  With a process group, every rank of the default
    group must call this with the same arguments, as
    ``torch.distributed.new_group`` requires: the groups are created in
    one fixed order.  Without one, the mesh must be the one rank."""
    import torch.distributed as dist

    ranks = tuple(int(r) for r in ranks)
    if math.prod(shape.values()) != len(ranks):
        raise ValueError(f"mesh shape {shape} does not hold {len(ranks)} "
                         "ranks")
    if not (dist.is_available() and dist.is_initialized()):
        if ranks != (0,):
            raise ValueError(f"ranks {list(ranks)} need a process group")
        return HostMesh(shape, ranks, 0, {})
    names = tuple(shape)
    grid = HostMesh(shape, ranks, None, {})
    groups = {}
    for axes in _axis_sets(names):
        key = frozenset(axes)
        rest = [n for n in names if n not in key]
        for coset in itertools.product(*(range(shape[n]) for n in rest)):
            fixed = dict(zip(rest, coset))
            members = []
            for pos, r in enumerate(grid.ranks):
                coords, p = {}, pos
                for n in reversed(names):
                    p, coords[n] = divmod(p, shape[n])
                if all(coords[n] == fixed[n] for n in rest):
                    members.append(r)
            groups[(key, tuple(coset))] = dist.new_group(members)
    return HostMesh(shape, ranks, dist.get_rank(), groups)


def make_production_mesh(*, multi_pod: bool = False) -> HostMesh:
    """The production mesh: ``{'data': 16, 'model': 16}`` over 256 ranks,
    or ``{'pod': 2, 'data': 16, 'model': 16}`` over 512 (``multi_pod``),
    rank ``r`` at the row-major position ``r``.  The default process
    group must have exactly that many ranks."""
    import torch.distributed as dist

    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod \
        else {"data": 16, "model": 16}
    n = math.prod(shape.values())
    world = dist.get_world_size() if (dist.is_available()
                                      and dist.is_initialized()) else 1
    if world != n:
        raise ValueError(f"the production mesh {shape} needs a process "
                         f"group of {n} ranks, not {world}")
    return build_mesh(shape, range(n))


def make_host_mesh(*, model: int = 1) -> HostMesh:
    """The ranks of the default process group (or this one process) as a
    ``('data', 'model')`` mesh: rank ``r`` at ``(r // model, r % model)``.
    ``model`` splits off the tensor-parallel axis and must divide the
    number of ranks."""
    import torch.distributed as dist

    n = dist.get_world_size() if (dist.is_available()
                                  and dist.is_initialized()) else 1
    if model < 1 or n % model != 0:
        raise ValueError(f"model={model} does not divide {n} devices")
    return build_mesh({"data": n // model, "model": model}, range(n))


def mesh_info(mesh) -> dict:
    return {"shape": dict(mesh.shape),
            "devices": int(math.prod(mesh.shape.values())),
            "axis_names": list(mesh.axis_names)}
