"""Nested dict / list trees of tensors — the port's pytrees.

The JAX package passes params, optimizer state and batches as pytrees.
The port keeps the same structures as plain dicts and lists and walks
them with these helpers, in JAX's leaf order: dict keys sorted, list and
tuple items in order.  ``None`` is an empty subtree (it maps to itself
and has no leaves), as in JAX.

Key paths join dict keys and list indices with ``/`` (``a/b/0/c``): the
on-disk layout of checkpoints (:mod:`repro_torch.checkpoint.ckpt`) and
merged-model artifacts (:mod:`repro_torch.runtime.artifact`).
"""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result has ``tree``'s
    structure (tuples come back as lists)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, prefix: str = ""):
    """``fn(key_path, leaf)`` over the leaves of ``tree``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], f"{prefix}{k}/")
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, t, f"{prefix}{i}/")
                for i, t in enumerate(tree)]
    return fn(prefix[:-1], tree)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    return list(flatten_tree(tree).values())


def flatten_tree(tree, prefix: str = "") -> dict[str, Any]:
    """``{'a/b/0/c': leaf}`` for a nested dict/list tree (sorted keys)."""
    out: dict[str, Any] = {}
    tree_map_with_path(out.__setitem__, tree, prefix)
    return out


def _listify(node):
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def unflatten_tree(flat: dict[str, Any]):
    """Rebuild the nested tree from key paths (all-digit levels are
    lists).  Empty subtrees have no key path, so they do not come back:
    rebuild into a known structure with :func:`tree_map_with_path`."""
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _listify(root)
