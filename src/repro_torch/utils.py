"""Trees of tensors: nested dicts, tuples and lists with tensor (or other)
leaves, the layout of the port's parameters, states and optimizer state.

Leaves come in the trees' own order (dict insertion order), which the
port keeps stable from the tree's construction; a path is the keys and
indices from the root, joined by "/" (the checkpoint manifest's names).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

IsLeaf = Optional[Callable[[Any], bool]]
_END = object()


def _children(tree, is_leaf: IsLeaf):
    if is_leaf is not None and is_leaf(tree):
        return None
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    return None


def tree_flatten_with_path(tree, is_leaf: IsLeaf = None) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in the tree's order."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        kids = _children(node, is_leaf)
        if kids is None:
            out.append(("/".join(path), node))
            return
        for k, v in kids:
            walk(v, path + (str(k),))
    walk(tree, ())
    return out


def tree_leaves(tree, is_leaf: IsLeaf = None) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree, is_leaf)]


def tree_unflatten(like, leaves, is_leaf: IsLeaf = None):
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)

    def build(node):
        kids = _children(node, is_leaf)
        if kids is None:
            return next(it)
        if isinstance(node, dict):
            return {k: build(v) for k, v in kids}
        return type(node)(build(v) for _, v in kids)
    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn, tree, *rest, is_leaf: IsLeaf = None):
    """fn over the leaves of ``tree`` and of the trees of its structure in
    ``rest``, leaf by leaf."""
    others = [tree_leaves(r, is_leaf) for r in rest]
    leaves = tree_leaves(tree, is_leaf)
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("trees of different structures")
    return tree_unflatten(tree, [fn(*ls) for ls in zip(leaves, *others)], is_leaf)
