"""Small shared utilities: integer rounding, byte and count formatting,
wall timers that wait for the card, and trees of tensors: nested dicts,
tuples and lists with tensor (or other) leaves, the layout of the port's
parameters, states and optimizer state.

Leaves come in the trees' own order (dict insertion order), which the
port keeps stable from the tree's construction; a path is the keys and
indices from the root, joined by "/" (the checkpoint manifest's names).

The recursions are module-level functions, not closures: a recursive
closure is a reference cycle, and one that holds the leaves (a train
step's gradients, say) keeps their device memory until Python's cycle
collector happens to run.
"""
from __future__ import annotations

import statistics
import time
from typing import Any, Callable, List, Optional, Tuple

import torch

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


# ---------------------------------------------------------------------------
# Sizes, counts and timers (the reference's ``repro/utils.py``: the same
# outputs; a leaf counts when it is a tensor, a meta tensor included)
# ---------------------------------------------------------------------------

def round_up(x: int, m: int) -> int:
    """Smallest multiple of m that is >= x."""
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def tree_bytes(tree: Any) -> int:
    """Bytes of the tensor leaves of a tree, from shapes and dtypes only (no
    device read; other leaves, such as a host int position, count
    nothing)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def tree_params(tree: Any) -> int:
    """Elements of the tensor leaves of a tree."""
    return sum(t.numel() for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB", "PiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}EiB"


def fmt_count(n: float) -> str:
    for unit in ("", "K", "M", "B", "T"):
        if abs(n) < 1000.0:
            return f"{n:.2f}{unit}"
        n /= 1000.0
    return f"{n:.2f}Q"


def _wait(tree: Any = None) -> None:
    """Wait for the card: every CUDA device holding a tensor leaf of
    ``tree``, or, when it holds none, the current device once CUDA is in
    use. Nothing on a machine that has not touched CUDA."""
    devices = {t.device for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    if not devices and torch.cuda.is_available() and torch.cuda.is_initialized():
        devices = {torch.device("cuda", torch.cuda.current_device())}
    for d in devices:
        torch.cuda.synchronize(d)


class Timer:
    """Context-manager wall timer that waits for the card at both ends:
    ``with Timer() as t: ...; t.s``."""

    def __enter__(self):
        _wait()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _wait()
        self.s = time.perf_counter() - self.t0
        return False


def timeit_median(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median wall time in seconds of fn(*args), each call timed until the
    card has finished it (its output's devices, or the current one)."""
    for _ in range(warmup):
        _wait(fn(*args))
    ts = []
    for _ in range(iters):
        _wait()
        t0 = time.perf_counter()
        _wait(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts))


def cast_tree(tree: Any, dtype) -> Any:
    """Cast the floating tensor leaves of a tree to dtype; other leaves as
    they are."""
    return tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                    and x.is_floating_point() else x, tree)
