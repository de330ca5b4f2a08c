"""Nested containers of arrays ("pytrees"): dicts, lists and tuples
(named tuples included) whose leaves are arrays, tensors or scalars, with
``None`` an empty subtree, as ``jax.tree`` treats them. The port's own
stand-in for the few ``jax.tree`` calls its utilities make."""

from __future__ import annotations

from collections.abc import Callable
from typing import Any


def is_node(x: Any) -> bool:
    return isinstance(x, (dict, list, tuple)) or x is None


def _children(tree: Any) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]  # jax.tree's key order
    return list(tree)


def leaves(tree: Any) -> list:
    """The leaves of ``tree``, in ``jax.tree.leaves``'s order."""
    if not is_node(tree):
        return [tree]
    return [leaf for child in _children(tree) for leaf in leaves(child)]


def same_structure(a: Any, b: Any) -> bool:
    """Whether ``a`` and ``b`` nest the same containers with the same keys."""
    if not is_node(a) or not is_node(b):
        return not is_node(a) and not is_node(b)
    if type(a) is not type(b):
        return False
    if isinstance(a, dict) and sorted(a) != sorted(b):
        return False
    ca, cb = _children(a), _children(b)
    return len(ca) == len(cb) and all(same_structure(x, y) for x, y in zip(ca, cb))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied to each leaf of ``tree`` (and the leaves at the same
    places in each of ``rest``), in a tree of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, *parts) for parts in zip(tree, *rest)]
        if isinstance(tree, list):
            return items
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree, *rest)
