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
here loads in the JAX package.  Publish is atomic (write ``path + '.tmp'``,
fsync, rename); :func:`load` re-verifies the fingerprint and raises
:class:`ArtifactError` on a missing, torn, corrupt or unknown-format file.
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

from . import ir

FORMAT_VERSION = 3
SUPPORTED_FORMATS = (1, 2, 3)


class ArtifactError(RuntimeError):
    """Raised when an artifact is missing, torn, corrupt, or stale."""


def flatten_tree(tree, prefix: str = "") -> dict[str, Any]:
    """``{'a/b/0/c': leaf}`` for a nested dict/list tree (sorted keys)."""
    if isinstance(tree, dict):
        out: dict = {}
        for k in sorted(tree):
            out.update(flatten_tree(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _listify(node):
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def unflatten_tree(flat: dict[str, Any]):
    """Rebuild the nested tree from key paths (all-digit levels are lists)."""
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _listify(root)


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
        h.update(np.ascontiguousarray(arr).tobytes())
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
    returns the content fingerprint."""
    spec, arrays = _payload(graph, plan, meta)
    fp = _digest(spec, arrays)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __spec__=np.array(json.dumps(spec)),
                 __fingerprint__=np.array(fp), **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return fp


def load(path: str, device="cuda") -> CompressedArtifact:
    """Load and verify an artifact, placing its tensors on ``device``
    (which defaults to the card and raises where there is none)."""
    from repro_torch.device import resolve

    dev = resolve(device)
    if not os.path.exists(path):
        raise ArtifactError(f"no artifact at {path}")
    try:
        with np.load(path, allow_pickle=False) as z:
            data = {k: z[k] for k in z.files}
    except (OSError, ValueError, zipfile.BadZipFile, KeyError) as e:
        raise ArtifactError(f"torn or unreadable artifact {path}: {e}") from e
    try:
        spec = json.loads(data.pop("__spec__").item())
        stored_fp = data.pop("__fingerprint__").item()
    except (KeyError, json.JSONDecodeError, ValueError) as e:
        raise ArtifactError(f"artifact {path} has no valid spec: {e}") from e
    if spec.get("format") not in SUPPORTED_FORMATS:
        raise ArtifactError(f"artifact {path} format {spec.get('format')!r} "
                            f"not in {SUPPORTED_FORMATS}")
    if _digest(spec, data) != stored_fp:
        raise ArtifactError(f"artifact {path} failed fingerprint "
                            "verification (corrupt weights or tampered spec)")
    if spec["family"] not in ("cnn", "transformer"):
        raise ArtifactError(f"artifact {path} has unknown family "
                            f"{spec['family']!r}")
    unit_arrays: list[dict] = [{} for _ in spec["units"]]
    global_arrays: dict = {}
    for key, arr in data.items():
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
