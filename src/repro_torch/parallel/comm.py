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
'model' axis of more than one rank runs them (``parallel(tp, sp)``, the
counterpart of the reference's ambient mesh): ``tp_reduce`` after a
row-parallel product, ``tp_gather`` where a column-split result must be
whole (the ARMT read), and the vocab-parallel embedding and head. Outside
such a context every one of them is the identity.

The 'stage' axis (the reference's ``stacked_axis="stage"``: with the slot
dim sharded over it, "diagonal batching becomes pipeline parallelism")
cuts the layer stack into ``size`` blocks of consecutive layers, one a
rank (``stage_range``). Where GSPMD lowers the reference's roll of the
slot buffer to a collective-permute, the port hands the slot on by hand:

  * ``stage_shift(x, mesh, send=, recv=)``: each rank sends x to the next
    stage and returns what the stage before sent (point to point: isend,
    irecv, then wait on both, so a chain of them never deadlocks); the
    first stage gets nothing back (None), the last sends nothing;
  * ``stage_broadcast(x, mesh)``: the last stage's x on every rank of the
    stage group (what leaves the stack: hidden states, the rows the head
    reads).

Whether a rank sends or receives at a step is host arithmetic on the
schedule (step, segments, layers) that every rank does alike, so the
calls stay matched without a message. Both are the identity, with no
collective, on a one-rank axis. Under gloo a CUDA tensor is staged
through host memory, as for the collectives above. Whatever only moves
bits (the gathers, broadcasts and hand-offs) moves a 2-byte float as its
bytes.

``StageParallel`` is what the executors read while an engine on a mesh
with a 'stage' axis of more than one rank runs them (the same
``parallel(tp, sp)``): this rank's block [lo, hi) of the ``n_layers``.
Outside such a context ``stage_last`` is the identity and the executors
run the whole stack.

Under gradients (grad mode on and an input that requires one) the
collectives are autograd Functions, Megatron's pair of conjugate
operators over a replicated value whose gradient every rank holds whole:

  * ``all_reduce``: the forward sums the partial products, the backward
    is the identity (each rank's partial had the whole sum's gradient);
  * ``enter(x, mesh, axis)`` (``tp_enter`` in a context): the identity
    forward, an all-reduce backward. It marks where a replicated value
    (the QKV and up projections' normed input, the ARMT read's and
    update's inputs, the head's input, a replicated weight read inside
    a split cell) enters computation split over the axis: each rank's
    gradient of it is then a partial sum, and the all-reduce makes it
    whole before it flows on to the norms, the embedding and the layers
    before;
  * ``all_gather``: the backward takes this rank's slice;
  * ``broadcast``: the backward hands the gradient to the source rank
    (zero elsewhere).

Outside autograd each is the detached form above, bit for bit. The
backwards stage CUDA tensors through the host under gloo as the forwards
do. ``stage_shift`` has no backward (the reference trains on no stage
axis) and refuses a tensor that requires a gradient.

``staged_counts()`` is the number and bytes of the collectives staged
through the host since the last ``reset_staged()`` (a gloo run on the
card: what a train step or a decode token moves over the bus).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import spec_of, stage_size


def _count(mesh, axes) -> int:
    return 1 if mesh is None else mesh.count(axes)


def _staged(mesh, x: torch.Tensor) -> bool:
    """gloo has no CUDA form of every collective: stage through the host."""
    return mesh.backend == "gloo" and x.is_cuda


_STAGED = {"calls": 0, "bytes": 0}


def staged_counts() -> dict:
    """{"calls", "bytes"}: collectives staged through host memory (and the
    bytes of the tensors they moved) since the last ``reset_staged``."""
    return dict(_STAGED)


def reset_staged() -> None:
    _STAGED.update(calls=0, bytes=0)


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A host copy of a CUDA tensor for a staged collective (counted)."""
    _STAGED["calls"] += 1
    _STAGED["bytes"] += x.numel() * x.element_size()
    return x.detach().to("cpu", copy=True)


def _grad_on(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _raw(x: torch.Tensor) -> torch.Tensor:
    """x (contiguous) as what a gather, broadcast or point-to-point moves: a
    2-byte float as its bytes (a view), which every backend carries (gloo
    has no int16, and bf16 only in recent builds)."""
    if x.element_size() == 2 and x.is_floating_point():
        return x.view(-1).view(torch.uint8)
    return x


def _reduce(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The detached sum over ``axis`` (a new tensor). Staged through the
    host, a 2-byte float is summed in fp32 there and rounded once (gloo
    sums bf16 only in recent builds)."""
    if _staged(mesh, x):
        h = _to_host(x)
        if h.element_size() == 2 and h.is_floating_point():
            w = h.float()
            dist.all_reduce(w, group=mesh.group(axis))
            return w.to(x.dtype).to(x.device)
        dist.all_reduce(h, group=mesh.group(axis))
        return h.to(x.device)
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=mesh.group(axis))
    return y


def _gather(x: torch.Tensor, mesh, axis, dim: int, n: int) -> torch.Tensor:
    src = x.detach().contiguous()
    dev = src.device
    if _staged(mesh, src):
        src = _to_host(src)
    bufs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather([_raw(b) for b in bufs], _raw(src), group=mesh.group(axis))
    return torch.cat(bufs, dim=dim).to(dev)


def _bcast(x: torch.Tensor, mesh, axis, index: int) -> torch.Tensor:
    y = _to_host(x) if _staged(mesh, x) else \
        x.detach().clone(memory_format=torch.contiguous_format)
    dist.broadcast(_raw(y), src=mesh.rank_at(axis, index), group=mesh.group(axis))
    return y.to(x.device)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, n):
        ctx.dim, ctx.size, ctx.index = dim, x.shape[dim], mesh.coord(axis)
        return _gather(x, mesh, axis, dim, n)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None, None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, index):
        ctx.source = mesh.coord(axis) == index
        return _bcast(x, mesh, axis, index)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.source else torch.zeros_like(g)), None, None, None


def all_reduce(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The sum of x over the ranks along ``axis`` (a new tensor; x itself
    when the axis has one rank). Under gradients its backward is the
    identity."""
    if _count(mesh, axis) == 1:
        return x
    return _AllReduce.apply(x, mesh, axis) if _grad_on(x) else _reduce(x, mesh, axis)


def enter(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """x itself, marked as a replicated value entering computation split
    over ``axis``: under gradients its backward all-reduces the gradient
    over the axis (the identity on a one-rank axis or without gradients)."""
    if _count(mesh, axis) == 1 or not _grad_on(x):
        return x
    return _Enter.apply(x, mesh, axis)


def all_gather(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """The blocks of the ranks along ``axis`` concatenated on ``dim``, in
    coordinate order (x itself when the axis has one rank). Under
    gradients its backward takes this rank's slice."""
    n = _count(mesh, axis)
    if n == 1:
        return x
    if _grad_on(x):
        return _AllGather.apply(x, mesh, axis, dim, n)
    return _gather(x, mesh, axis, dim, n)


def broadcast(x: torch.Tensor, mesh, axis, index: int) -> torch.Tensor:
    """The tensor of the rank at ``index`` along ``axis``, on every rank of
    the group (a new tensor; x itself when the axis has one rank). Under
    gradients the source rank's input takes the gradient, the others'
    none."""
    if _count(mesh, axis) == 1:
        return x
    if _grad_on(x):
        return _Broadcast.apply(x, mesh, axis, index)
    return _bcast(x, mesh, axis, index)


BUCKET_BYTES = 256 << 20    # the largest flat bucket of all_reduce_buckets


def all_reduce_buckets(tensors, mesh, axes) -> list:
    """Each tensor summed over ``axes`` (detached), in a few collectives: the
    tensors of one dtype flattened, in order, into buckets of about
    ``BUCKET_BYTES`` (a tensor is never split), one all-reduce a bucket;
    the results are views of the reduced buckets. The tensors themselves
    on a one-rank axis."""
    out = list(tensors)
    if _count(mesh, axes) == 1:
        return out
    groups: dict = {}
    for i, t in enumerate(out):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        bucket, size = [], 0
        for n, i in enumerate(idx):
            bucket.append(i)
            size += out[i].numel() * out[i].element_size()
            if size >= BUCKET_BYTES or n == len(idx) - 1:
                flat = torch.cat([out[j].detach().reshape(-1) for j in bucket])
                if _staged(mesh, flat):
                    flat = _reduce(flat, mesh, axes)
                else:       # a fresh tensor: reduced in place
                    dist.all_reduce(flat, group=mesh.group(axes))
                off = 0
                for j in bucket:
                    k = out[j].numel()
                    out[j] = flat[off:off + k].view(out[j].shape)
                    off += k
                bucket, size = [], 0
    return out


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

    def enter(self, x):
        return enter(x, self.mesh, "model")

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
        the local rows of w summed. Under gradients h enters the split
        product (``enter``): each rank's gradient of it is partial."""
        if split == "vocab":
            return self.gather(torch.matmul(self.enter(h), w), -1)
        if split == "d":
            lo = self.index * w.shape[0]
            return self.reduce(torch.matmul(self.enter(h)[..., lo:lo + w.shape[0]], w))
        return torch.matmul(h, w)


_TP: Optional[TensorParallel] = None


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


def tp_enter(x: torch.Tensor) -> torch.Tensor:
    """A replicated value entering a split computation: x itself, its
    gradient all-reduced over 'model' (identity outside a context)."""
    return x if _TP is None else _TP.enter(x)


def tp_enter_keys(p: dict, *keys) -> dict:
    """p with the replicated leaves (or subtrees) at ``keys`` that a split
    cell reads whole through ``tp_enter`` (p itself outside a context)."""
    if _TP is None:
        return p
    out = dict(p)
    for k in keys:
        if k in out:
            out[k] = (_TP.enter(out[k]) if isinstance(out[k], torch.Tensor)
                      else {n: _TP.enter(t) for n, t in out[k].items()})
    return out


# ---------------------------------------------------------------------------
# The stage axis: one block of consecutive layers a rank
# ---------------------------------------------------------------------------

def stage_range(n_layers: int, mesh) -> tuple:
    """[a, b) of this rank's layer block on the mesh's 'stage' axis (the
    whole stack without one)."""
    if mesh is None or "stage" not in mesh.axis_names:
        return 0, n_layers
    return block_range(n_layers, mesh, "stage")


def stage_shift(x: torch.Tensor, mesh, *, send: bool = True, recv: bool = True):
    """The roll of the slot dim over 'stage' as a hand-off: x to the next
    stage (when ``send`` and this is not the last), and what the stage
    before sent (when ``recv`` and this is not the first; a new tensor of
    x's shape and dtype) -> the received tensor or None. x is also the
    receive's template, so a rank with nothing to send passes any tensor of
    the slot's shape. x itself on a one-rank axis."""
    n = 1 if mesh is None else stage_size(mesh)
    if n == 1:
        return x
    if _grad_on(x):
        raise ValueError("stage_shift under gradients: the reference trains on no 'stage' "
                         "axis, and neither does the port")
    r = mesh.coord("stage")
    send, recv = send and r < n - 1, recv and r > 0
    staged = _staged(mesh, x)
    works, out = [], None
    if send:
        src = _to_host(x) if staged else x.detach().contiguous()
        works.append(dist.isend(_raw(src), mesh.rank_at("stage", r + 1)))
    if recv:
        out = torch.empty(x.shape, dtype=x.dtype, device="cpu" if staged else x.device)
        works.append(dist.irecv(_raw(out), mesh.rank_at("stage", r - 1)))
    for w in works:
        w.wait()
    return None if out is None else out.to(x.device)


def stage_broadcast(x: torch.Tensor, mesh) -> torch.Tensor:
    """The last stage's x on every rank of the stage group (a new tensor;
    x itself on a one-rank axis)."""
    n = 1 if mesh is None else stage_size(mesh)
    return x if n == 1 else broadcast(x, mesh, "stage", n - 1)


class StageParallel:
    """The 'stage' axis the executors pipeline over: its size, this rank's
    index and its block [lo, hi) of the ``n_layers`` of the stack."""

    def __init__(self, mesh, n_layers: int):
        self.mesh = mesh
        self.size = mesh.count("stage")
        self.index = mesh.coord("stage")
        self.n_layers = n_layers
        self.lo, self.hi = stage_range(n_layers, mesh)

    def __repr__(self) -> str:
        return f"StageParallel({self.index} of {self.size}, layers [{self.lo}, {self.hi}))"


_SP: Optional[StageParallel] = None


@contextlib.contextmanager
def parallel(tp: Optional[TensorParallel], sp: Optional[StageParallel] = None):
    """Run inside a rank's mesh contexts: the cells split over ``tp``'s
    axis, the executors on ``sp``'s block of the layers (None: whole, as
    outside any context)."""
    global _TP, _SP
    prev, (_TP, _SP) = (_TP, _SP), (tp, sp)
    try:
        yield
    finally:
        _TP, _SP = prev


def current_stage() -> Optional[StageParallel]:
    return _SP


def stage_last(x: torch.Tensor) -> torch.Tensor:
    """What leaves the stack: the last stage's x on every rank (x itself
    outside a stage context)."""
    return x if _SP is None else stage_broadcast(x, _SP.mesh)
