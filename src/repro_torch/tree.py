"""Nested containers of tensors: the port's stand-in for JAX pytrees.

A tree is a tensor (a leaf), ``None`` (empty), or a dict, list or tuple
of trees.  Dicts keep their insertion order, so every tree built from
one parameter tree walks its leaves in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, List

__all__ = ["tree_leaves", "tree_map"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree``, in :func:`tree_map`'s order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out
