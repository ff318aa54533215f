"""Explicit collectives over a ``launch.mesh.Mesh``, the cut of a tensor into
its blocks, and the tensor-parallel context the cells read.

The reference needs none of this: its rules annotate arguments and GSPMD
inserts the collectives. The port computes each cell on its local shard
(Megatron style) and places the collectives by hand:

  * ``all_reduce(x, mesh, axis)``: the sum over the ranks along ``axis``
    (a row-parallel product's partial sums);
  * ``all_gather(x, mesh, axis, dim)``: the blocks along ``axis``
    concatenated on ``dim`` in coordinate order;
  * ``broadcast(x, mesh, axis, index)``: the block of the rank at
    ``index`` along ``axis``.

Each is the identity, with no collective launched, when the axis has one
rank, so a one-rank mesh keeps the mesh-less engine's bits.

NCCL is the backend for one rank a GPU. Two ranks on one card can only use
gloo, whose collectives on CUDA tensors are partial (no all-gather), so
under gloo every collective of a CUDA tensor is staged through host memory:
copied to the host, reduced or gathered there, and copied back. The
kernels still run on the card; only the collective's bytes cross the bus.

``local_block(t, spec, mesh)`` cuts this rank's block of a whole tensor;
``shard_tree``/``gather_tree`` apply it, or its inverse, to every leaf of a
tree against a tree of specs (``parallel/sharding.py``).

``TensorParallel`` is what the cells read while an engine on a mesh with a
'model' axis of more than one rank runs them (``tensor_parallel(tp)``, the
counterpart of the reference's ambient mesh): ``tp_reduce`` after a
row-parallel product, ``tp_gather`` where a column-split result must be
whole (the ARMT read), and the vocab-parallel embedding and head. Outside
such a context every one of them is the identity.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import spec_of


def _count(mesh, axes) -> int:
    return 1 if mesh is None else mesh.count(axes)


def _staged(mesh, x: torch.Tensor) -> bool:
    """gloo has no CUDA form of every collective: stage through the host."""
    return mesh.backend == "gloo" and x.is_cuda


def all_reduce(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The sum of x over the ranks along ``axis`` (a new tensor; x itself
    when the axis has one rank)."""
    if _count(mesh, axis) == 1:
        return x
    if _staged(mesh, x):
        h = x.detach().to("cpu", copy=True)
        dist.all_reduce(h, group=mesh.group(axis))
        return h.to(x.device)
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=mesh.group(axis))
    return y


def all_gather(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """The blocks of the ranks along ``axis`` concatenated on ``dim``, in
    coordinate order (x itself when the axis has one rank)."""
    n = _count(mesh, axis)
    if n == 1:
        return x
    src = x.detach().contiguous()
    dev = src.device
    if _staged(mesh, src):
        src = src.cpu()
    bufs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(bufs, src, group=mesh.group(axis))
    return torch.cat(bufs, dim=dim).to(dev)


def broadcast(x: torch.Tensor, mesh, axis, index: int) -> torch.Tensor:
    """The tensor of the rank at ``index`` along ``axis``, on every rank of
    the group (a new tensor; x itself when the axis has one rank)."""
    if _count(mesh, axis) == 1:
        return x
    y = x.detach().to("cpu", copy=True) if _staged(mesh, x) else \
        x.detach().clone(memory_format=torch.contiguous_format)
    dist.broadcast(y, src=mesh.rank_at(axis, index), group=mesh.group(axis))
    return y.to(x.device)


def block_range(n: int, mesh, axes) -> tuple:
    """[lo, hi) of this rank's block of a dim of n sharded over ``axes``."""
    k = _count(mesh, axes)
    if n % k:
        raise ValueError(f"a dim of {n} does not split over {k} ranks of {axes}")
    i = 0 if mesh is None else mesh.coord(axes)
    return i * (n // k), (i + 1) * (n // k)


def local_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor t under ``spec`` (a view)."""
    for d, axes in enumerate(spec_of(spec)):
        if axes is None:
            continue
        lo, hi = block_range(t.shape[d], mesh, axes)
        t = t.narrow(d, lo, hi - lo)
    return t


def gather_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from this rank's block t under ``spec``: every
    sharded dim all-gathered (the inverse of ``local_block``)."""
    for d, axes in enumerate(spec_of(spec)):
        if axes is not None:
            t = all_gather(t, mesh, axes, d)
    return t


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def shard_tree(tree, specs, mesh, device=None, copy: bool = True):
    """Every tensor leaf's block under its spec, contiguous (on ``device``
    when given): a fresh tensor, or with ``copy=False`` a view of the leaf
    wherever the block is one already (a replicated leaf, a block of rows);
    other leaves (a host int ``pos``) as they are."""
    def one(t, s):
        if not isinstance(t, torch.Tensor):
            return t
        b = local_block(t, s, mesh)
        if device is not None and b.device != torch.device(device):
            return b.to(device, copy=True).contiguous()
        return b.clone(memory_format=torch.contiguous_format) if copy else b.contiguous()
    return _zip_map(one, tree, specs)


def gather_tree(tree, specs, mesh):
    """Every tensor leaf gathered whole from its blocks (``gather_block``);
    other leaves as they are."""
    return _zip_map(lambda t, s: gather_block(t, s, mesh) if isinstance(t, torch.Tensor)
                    else t, tree, specs)


# ---------------------------------------------------------------------------
# The tensor-parallel context of the cells
# ---------------------------------------------------------------------------

class TensorParallel:
    """The 'model' axis the cells split over: its size and this rank's
    index, and how the embedding and the head are split, each one of
    "vocab" (rows of the table / columns of the head: gather or mask, then
    collect), "d" (the model dim) or None (whole)."""

    def __init__(self, mesh, embed_split: Optional[str], head_split: Optional[str]):
        self.mesh = mesh
        self.size = mesh.count("model")
        self.index = mesh.coord("model")
        self.embed_split = embed_split
        self.head_split = head_split

    def reduce(self, x):
        return all_reduce(x, self.mesh, "model")

    def gather(self, x, dim: int = -1):
        return all_gather(x, self.mesh, "model", dim % x.dim())

    def embed(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of the embedding from this rank's block of it: under
        a vocab split the rows of the local vocab slice (others zero), then
        the sum over the axis (exact: one rank holds each row); under a d
        split the local columns, then all-gathered."""
        if self.embed_split == "vocab":
            n = table.shape[0]
            local = ids - self.index * n
            inside = (local >= 0) & (local < n)
            rows = table[local.clamp(0, n - 1)]
            return self.reduce(torch.where(inside[..., None], rows, torch.zeros_like(rows)))
        if self.embed_split == "d":
            return self.gather(table[ids], -1)
        return table[ids]

    def logits(self, h: torch.Tensor, w: torch.Tensor, split: Optional[str]) -> torch.Tensor:
        """h [..., D] @ the head w [D, V] from this rank's block of w: a vocab
        split's local logits all-gathered; a d split's partial products over
        the local rows of w summed."""
        if split == "vocab":
            return self.gather(torch.matmul(h, w), -1)
        if split == "d":
            lo = self.index * w.shape[0]
            return self.reduce(torch.matmul(h[..., lo:lo + w.shape[0]], w))
        return torch.matmul(h, w)


_TP: Optional[TensorParallel] = None


@contextlib.contextmanager
def tensor_parallel(tp: Optional[TensorParallel]):
    """Run the cells inside this context split over ``tp``'s axis (None:
    whole, as outside any context)."""
    global _TP
    prev, _TP = _TP, tp
    try:
        yield tp
    finally:
        _TP = prev


def current() -> Optional[TensorParallel]:
    return _TP


def tp_active() -> bool:
    return _TP is not None


def tp_reduce(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sum made whole (identity outside a
    context)."""
    return x if _TP is None else _TP.reduce(x)


def tp_gather(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """A column-split result made whole on ``dim`` (identity outside a
    context)."""
    return x if _TP is None else _TP.gather(x, dim)
