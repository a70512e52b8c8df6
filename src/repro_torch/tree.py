"""Nested dicts of tensors as trees, in the JAX package's leaf order.

The port keeps parameters, gradients and optimizer state as plain nested
dicts.  These helpers walk them as ``jax.tree_util`` walks a dict: keys in
sorted order, every non-dict value a leaf, and a leaf's key path joined
with ``/`` (``"layers/attn_norm/scale"``), the key of the JAX package's
checkpoint files.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_leaves", "tree_map", "tree_items", "tree_map_with_keys"]


def tree_items(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(key path, leaf)`` pairs in sorted-key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(tree_items(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def tree_leaves(tree: Any) -> list:
    """The leaves in sorted-key order (``jax.tree_util.tree_leaves``)."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which must have ``tree``'s keys."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    for r in rest:
        if not isinstance(r, dict) or set(r) != set(tree):
            raise ValueError(f"tree_map: keys {sorted(tree)} against "
                             f"{sorted(r) if isinstance(r, dict) else r!r}")
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}


def tree_map_with_keys(fn: Callable[[str, Any], Any], tree: Any,
                       prefix: str = "") -> Any:
    """``fn(key path, leaf)`` over the leaves, keeping the structure."""
    if not isinstance(tree, dict):
        return fn(prefix, tree)
    return {k: tree_map_with_keys(fn, v, f"{prefix}/{k}" if prefix
                                  else str(k))
            for k, v in tree.items()}
