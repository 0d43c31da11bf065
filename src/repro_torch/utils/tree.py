"""Minimal pytree helpers over nested tuples, lists and dicts of tensors,
the containers the port's parameter and pool trees are built from."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over ``tree`` and same-structured ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
