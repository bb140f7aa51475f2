"""Minimal pytree helpers over the port's nested containers.

Params and caches keep the reference's nesting (dicts, lists, tuples and
NamedTuples of arrays); these helpers map over the tensor leaves.
"""
from __future__ import annotations

from typing import Any, Callable, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of ``tree`` (``None`` leaves stay
    ``None``), keeping the containers."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if tree is None:
        return None
    return fn(tree)


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``tree_map`` whose ``fn(path, leaf)`` also gets the leaf's key path:
    a tuple of dict keys, sequence indices and NamedTuple field names, the
    entries of a jax key path."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, x, path + (f,))
                            for f, x in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, x, path + (i,))
                          for i, x in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def leaves(tree, is_leaf: Callable = None) -> List[Any]:
    """Leaves in a deterministic order (dict keys sorted, as jax does);
    ``is_leaf(node)`` true stops the descent at ``node``."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [l for x in tree for l in leaves(x, is_leaf)]
    if tree is None:
        return []
    return [tree]


def copy_leaves(dst, src):
    """Copy each leaf of ``src`` into the leaf of ``dst`` at its place, in
    place (trees of one structure; a leaf that already is ``dst``'s is
    left alone)."""
    for d, s in zip(leaves(dst), leaves(src)):
        if s is not d:
            d.copy_(s)
