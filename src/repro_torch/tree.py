"""Nested-container walks for parameter and state trees.

The JAX package leans on ``jax.tree_util``; the port's trees are plain
dicts, lists, tuples and NamedTuples of tensors, walked here.  Paths use
the reference checkpoint's key convention so both packages name every
leaf the same way: a dict key as itself, a list/tuple position as its
index, a NamedTuple field as ``.name``.  ``None`` is an empty subtree.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

Path = Tuple[Any, ...]


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_path(tree, is_leaf: Optional[Callable] = None,
                     path: Path = ()) -> List[Tuple[Path, Any]]:
    """``[(path, leaf), ...]`` in a fixed order (dict keys sorted)."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_path(tree[k], is_leaf, path + (k,))
        return out
    if is_namedtuple(tree):
        out = []
        for name in tree._fields:
            out += leaves_with_path(getattr(tree, name), is_leaf,
                                    path + ("." + name,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, x in enumerate(tree):
            out += leaves_with_path(x, is_leaf, path + (i,))
        return out
    return [(path, tree)]


def map_with_path(fn: Callable, tree, is_leaf: Optional[Callable] = None,
                  path: Path = ()):
    """Rebuild ``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, is_leaf, path + (k,))
                for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, getattr(tree, n), is_leaf,
                                          path + ("." + n,))
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, x, is_leaf, path + (i,))
                          for i, x in enumerate(tree))
    return fn(path, tree)


def tree_map(fn: Callable, tree, is_leaf: Optional[Callable] = None):
    return map_with_path(lambda _p, x: fn(x), tree, is_leaf)


def path_str(path: Path) -> str:
    """The checkpoint key of a path: ``0/torso/convs/1/w``."""
    return "/".join(str(p) for p in path)


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> List[Any]:
    """The leaves in ``leaves_with_path``'s order (dict keys sorted, as
    ``jax.tree.leaves`` orders them)."""
    return [leaf for _, leaf in leaves_with_path(tree, is_leaf)]


def tree_unflatten(tree, leaves: List[Any]):
    """``tree`` with its leaves replaced, in ``tree_leaves`` order."""
    by_path = {p: new for (p, _), new in
               zip(leaves_with_path(tree), leaves, strict=True)}
    return map_with_path(lambda p, _x: by_path[p], tree)
