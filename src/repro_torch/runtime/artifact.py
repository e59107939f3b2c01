"""Merged-model artifacts — the JAX package's ``.npz`` format, version 3.

One ``.npz`` file holds everything needed to run a compressed network:

* ``__spec__`` — JSON: format version, graph family, static unit records
  (:func:`repro_torch.runtime.ir.unit_static`), graph meta (the
  transformer ``ArchConfig`` as a plain dict), global axes,
  the compression plan (``CompressionPlan.to_json`` payload) and caller
  metadata (certifying oracle, latencies, source);
* ``u<i>/<keypath>`` — the merged weights of unit ``i`` (``i`` zero-padded
  to four digits), flattened by key path (``a/b/0/c``: dict keys and list
  indices joined by ``/``);
* ``g/<keypath>`` — graph-level params (the classifier head; embed,
  final norm and unembed);
* ``__fingerprint__`` — sha256 over the spec JSON (sorted keys) and every
  array's key, dtype, shape and raw bytes, keys in sorted order.

Tensors go to host numpy arrays before hashing, so an artifact written by
the JAX package loads here with its fingerprint verified, and one written
here loads in the JAX package.  Every unit record and the graph carry
``axes`` (logical names per array key): :func:`load` with ``rules`` keeps
on each rank only its block of every array whose names resolve to a
split placement (a v1 artifact, with no axes, loads whole).  Publish is atomic (write ``path + '.tmp'``,
fsync, rename); :func:`load` re-verifies the fingerprint and raises
:class:`ArtifactError` on a missing, torn, corrupt or unknown-format file,
after renaming a torn or corrupt one to ``<path>.corrupt``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.tree import flatten_tree, unflatten_tree

from . import ir

FORMAT_VERSION = 3
SUPPORTED_FORMATS = (1, 2, 3)


class ArtifactError(RuntimeError):
    """Raised when an artifact is missing, torn, corrupt, or stale."""


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _meta_to_spec(meta: dict) -> dict:
    out = dict(meta)
    cfg = out.get("config")
    if cfg is not None and dataclasses.is_dataclass(cfg):
        out["config"] = dataclasses.asdict(cfg)
    return out


def _meta_from_spec(spec_meta: dict) -> dict:
    out = dict(spec_meta)
    if isinstance(out.get("config"), dict):
        from repro_torch.configs.base import ArchConfig

        d = dict(out["config"])
        d["temporal_pattern"] = tuple(d.get("temporal_pattern", ("attn",)))
        out["config"] = ArchConfig(**d)
    return out


def _payload(graph: ir.UnitGraph, plan=None, meta: dict | None = None):
    spec = {
        "format": FORMAT_VERSION,
        "family": graph.family,
        "graph_meta": _meta_to_spec(graph.meta),
        "global_axes": graph.axes,
        "meta": meta or {},
        "plan": json.loads(plan.to_json()) if plan is not None else None,
        "units": [ir.unit_static(u) for u in graph.units],
    }
    arrays: dict[str, np.ndarray] = {}
    for i, u in enumerate(graph.units):
        for k, v in flatten_tree(u.params).items():
            arrays[f"u{i:04d}/{k}"] = _to_numpy(v)
    for k, v in flatten_tree(graph.params).items():
        arrays[f"g/{k}"] = _to_numpy(v)
    return spec, arrays


def _digest(spec: dict, arrays: dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    h.update(json.dumps(spec, sort_keys=True).encode())
    for key in sorted(arrays):
        arr = arrays[key]
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        # the bytes of ``tobytes()``, hashed in place (no copy)
        h.update(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    return h.hexdigest()


def fingerprint(graph: ir.UnitGraph, plan=None, meta: dict | None = None
                ) -> str:
    """Content fingerprint of the artifact :func:`save` would publish."""
    return _digest(*_payload(graph, plan, meta))


@dataclasses.dataclass
class CompressedArtifact:
    """A loaded merged-model artifact; its tensors live on ``device``."""

    graph: ir.UnitGraph
    plan: Any                        # CompressionPlan | None
    fingerprint: str
    meta: dict
    path: str = ""
    device: torch.device = torch.device("cpu")

    def apply(self, inputs):
        """Forward pass: an NHWC image batch (cnn) or a token batch
        ``{"tokens": (B, S)}`` (transformer prefill)."""
        from . import executor
        return executor.execute(self.graph, inputs, device=self.device)

    def init_cache(self, batch_size: int, seq_len: int):
        """Fresh per-unit decode state (transformer family)."""
        from . import executor
        return executor.init_cache(self.graph, batch_size, seq_len)

    def make_serve_step(self):
        """``(step(params, cache, batch), params)`` (transformer family;
        :func:`~repro_torch.runtime.executor.make_serve_step`)."""
        from . import executor
        return executor.make_serve_step(self.graph)

    def executor(self, rules=None):
        """A :class:`~repro_torch.runtime.executor.GraphExecutor` over the
        graph; pass the ``rules`` the artifact was loaded with."""
        from . import executor
        return executor.GraphExecutor(self.graph, rules)

    def decode(self, cache, tokens):
        """One decode step: ``tokens`` (B, 1) → ``(logits, cache)``, the
        cache's tensors updated in place (transformer family); the cache
        is :meth:`init_cache`'s or the continuous engine's per-slot state
        (:func:`~repro_torch.runtime.executor.slot_state`, a position per
        row).  Tokens already on the artifact's device are used as they
        are, not copied."""
        from . import executor
        return executor.decode_step(
            self.graph, cache, {"tokens": torch.as_tensor(
                tokens, device=self.device)})


def save(path: str, graph: ir.UnitGraph, plan=None,
         meta: dict | None = None) -> str:
    """Atomically publish ``graph`` (+ plan + metadata) to ``path``;
    returns the content fingerprint.  Only the main process
    (:func:`repro_torch.launch.distributed.is_main`) writes the file;
    every process computes and returns the fingerprint, so all agree on
    the artifact's identity."""
    from repro_torch.checkpoint.ckpt import atomic_writer
    from repro_torch.launch.distributed import is_main

    spec, arrays = _payload(graph, plan, meta)
    fp = _digest(spec, arrays)
    if not is_main():
        return fp
    with atomic_writer(path) as f:
        np.savez(f, __spec__=np.array(json.dumps(spec)),
                 __fingerprint__=np.array(fp), **arrays)
    return fp


def _corrupt(path: str, msg: str) -> ArtifactError:
    """Quarantine a corrupt artifact (``<path>.corrupt``, the table
    cache's contract) and build the error naming where it went and how to
    recover: the next publish to ``path`` starts clean."""
    from repro_torch.core.table_cache import quarantine

    dst = quarantine(path)
    where = f" (quarantined to {dst})" if dst else ""
    return ArtifactError(
        f"{msg}{where}; re-publish with repro_torch.runtime.save(...) or "
        "CompressResult.save(...)")


def _key_axes(spec: dict, key: str):
    """Recorded logical names of one array key ('u<i>/…' or 'g/…')."""
    if key.startswith("g/"):
        return spec.get("global_axes", {}).get(key[2:])
    idx, sub = key.split("/", 1)
    return spec["units"][int(idx[1:])].get("axes", {}).get(sub)


def load(path: str, rules=None, device="cuda") -> CompressedArtifact:
    """Load and verify an artifact, placing its tensors on ``device``
    (which defaults to the card and raises where there is none).

    A torn, corrupt or tampered file is renamed to ``<path>.corrupt``
    before the error is raised, so it cannot wedge every later load or
    block a re-publish; a file of an unsupported format version is left
    in place (another version of the code may read it).

    With ``rules`` (a :class:`~repro_torch.sharding.rules.ShardingRules`
    over a mesh) each array's recorded logical axes resolve, with the
    divisibility fallback, to a placement: only this rank's block is
    copied to ``device``, carrying the placement as its ``sharding``
    (:meth:`CompressedArtifact.executor` then runs it).  v1 artifacts
    carry no annotations and load whole."""
    from repro_torch.device import resolve

    dev = resolve(device)
    if not os.path.exists(path):
        raise ArtifactError(f"no artifact at {path}")
    try:
        with np.load(path, allow_pickle=False) as z:
            data = {k: z[k] for k in z.files}
    except (OSError, ValueError, zipfile.BadZipFile, KeyError) as e:
        raise _corrupt(path, f"torn or unreadable artifact {path}: {e}") \
            from e
    try:
        spec = json.loads(data.pop("__spec__").item())
        stored_fp = data.pop("__fingerprint__").item()
    except (KeyError, json.JSONDecodeError, ValueError) as e:
        raise _corrupt(path, f"artifact {path} has no valid spec: {e}") \
            from e
    if spec.get("format") not in SUPPORTED_FORMATS:
        raise ArtifactError(f"artifact {path} format {spec.get('format')!r} "
                            f"not in {SUPPORTED_FORMATS}")
    if _digest(spec, data) != stored_fp:
        raise _corrupt(path, f"artifact {path} failed fingerprint "
                       "verification (corrupt weights or tampered spec)")
    if spec["family"] not in ("cnn", "transformer"):
        raise ArtifactError(f"artifact {path} has unknown family "
                            f"{spec['family']!r}")
    sharded = rules is not None and rules.mesh is not None
    unit_arrays: list[dict] = [{} for _ in spec["units"]]
    global_arrays: dict = {}
    for key, arr in data.items():
        if sharded:
            from repro_torch.sharding.rules import with_sharding
            place = rules.named(tuple(_key_axes(spec, key) or ()),
                                arr.shape)
            block = arr[place.slices(arr.shape)] if place.split_dims() \
                else arr
            val = with_sharding(
                torch.from_numpy(np.array(block, copy=True)).to(dev), place)
        else:
            val = torch.from_numpy(np.array(arr, copy=True)).to(dev)
        if key.startswith("g/"):
            global_arrays[key[2:]] = val
        else:
            idx, sub = key.split("/", 1)
            unit_arrays[int(idx[1:])][sub] = val
    units = tuple(ir.unit_from_static(static, unflatten_tree(flat))
                  for static, flat in zip(spec["units"], unit_arrays))
    graph = ir.UnitGraph(family=spec["family"], units=units,
                         params=unflatten_tree(global_arrays),
                         meta=_meta_from_spec(spec["graph_meta"]),
                         axes=spec.get("global_axes", {}))
    plan = None
    if spec.get("plan") is not None:
        from repro_torch.core.plan import CompressionPlan
        plan = CompressionPlan.from_json(json.dumps(spec["plan"]))
    return CompressedArtifact(graph=graph, plan=plan, fingerprint=stored_fp,
                              meta=spec.get("meta", {}), path=path,
                              device=dev)
