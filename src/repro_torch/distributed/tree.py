"""Nested dict / list / tuple trees of tensors: the little of
``jax.tree_util`` the distributed modules use, in its leaf order (dict
keys sorted, sequences by index), so a tree flattens to the same vector
in both packages."""

from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), called in ``tree_leaves`` order, keeping the structure."""
    if isinstance(tree, dict):
        done = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        return type(tree)(vals)
    return fn(tree, *rest)
