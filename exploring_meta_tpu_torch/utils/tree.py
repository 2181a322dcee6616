"""Minimal pytree helpers for nested dict/list/tuple params.

Path keys follow ``jax.tree_util``'s: dict keys in sorted order, list and
tuple positions as their index, joined with ``/`` (``base/0/conv/w``).
"""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over ``tree`` and same-structured ``rest``
    (NamedTuples, a Trajectory, are rebuilt as themselves)."""
    if hasattr(tree, "_fields"):
        return type(tree)(*tree_map(fn, tuple(tree), *map(tuple, rest)))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_items(tree, prefix: str = ""):
    """-> ``[(slash/path, leaf)]`` in ``jax.tree_util`` flatten order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
    elif isinstance(tree, (list, tuple)):
        keys = range(len(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k in keys:
        out.extend(tree_items(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def tree_leaves(tree) -> list:
    """Leaves in :func:`tree_map`'s traversal order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """Inverse of :func:`tree_leaves`: ``leaves`` in ``like``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_from_items(items) -> dict:
    """Inverse of :func:`tree_items`: nested dicts from slash paths, where a
    level whose keys are exactly ``0..n-1`` becomes a list."""
    root: dict = {}
    for path, leaf in items:
        *heads, last = path.split("/")
        node = root
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)
