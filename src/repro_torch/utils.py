"""Trees of tensors: nested dicts, tuples and lists with tensor (or other)
leaves, the layout of the port's parameters, states and optimizer state.

Leaves come in the trees' own order (dict insertion order), which the
port keeps stable from the tree's construction; a path is the keys and
indices from the root, joined by "/" (the checkpoint manifest's names).

The recursions are module-level functions, not closures: a recursive
closure is a reference cycle, and one that holds the leaves (a train
step's gradients, say) keeps their device memory until Python's cycle
collector happens to run.
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


def _walk(node, path, is_leaf: IsLeaf, out: list) -> None:
    kids = _children(node, is_leaf)
    if kids is None:
        out.append(("/".join(path), node))
        return
    for k, v in kids:
        _walk(v, path + (str(k),), is_leaf, out)


def tree_flatten_with_path(tree, is_leaf: IsLeaf = None) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in the tree's order."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, (), is_leaf, out)
    return out


def tree_leaves(tree, is_leaf: IsLeaf = None) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree, is_leaf)]


def _build(node, it, is_leaf: IsLeaf):
    kids = _children(node, is_leaf)
    if kids is None:
        return next(it)
    if isinstance(node, dict):
        return {k: _build(v, it, is_leaf) for k, v in kids}
    return type(node)(_build(v, it, is_leaf) for _, v in kids)


def tree_unflatten(like, leaves, is_leaf: IsLeaf = None):
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    out = _build(like, it, is_leaf)
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
