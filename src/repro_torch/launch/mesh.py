"""Meshes over ``torch.distributed``: the reference's ``launch/mesh.py``
with the same ``--mesh`` grammar, axis order and error messages.

A JAX mesh is a grid of devices that GSPMD partitions a program over. The
port's ``Mesh`` is a grid of the process group's ranks, one rank a GPU
(NCCL), or several ranks on one card over gloo. It wraps a
``torch.distributed.device_mesh.DeviceMesh`` and exposes what the
sharding rules read of a JAX mesh (``axis_names``, a ``shape`` dict,
``size``) plus what the explicit collectives need: this rank's coordinate
on each axis (``coord``) and the group of the ranks that differ from it
only on some axes (``group``). Every group is made when the mesh is, by
every rank alike, so that no collective path can create one on some ranks
only.

Without an initialised process group ``parse_mesh`` returns an
``AbstractMesh``: the shape alone, which the rules read as they read
``jax.sharding.AbstractMesh`` (dry runs, the CPU tests of the rules).

``init_distributed`` joins the process group from ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), or
from a ``FileStore`` path with an explicit rank and world size (the tests'
way: no port to share between test workers).
"""
from __future__ import annotations

import itertools
import math
import os
from typing import Dict, Optional, Sequence, Tuple

_MESH_AXES = ("pod", "data", "model", "stage")

# H100 SXM5 80 GB at its 700 W limit (NVIDIA's data sheet), per card: the
# roofline constants (PERF.md section 6 bounds every kernel with the first
# two)
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 on the tensor cores (H100 SXM, 700 W)
HBM_BW = 3.35e12              # B/s, HBM3 (H100 SXM, 700 W)
NVLINK_BW = 450e9             # B/s a direction, NVLink 4 (H100 SXM, 700 W)


class AbstractMesh:
    """A mesh's axis names and sizes without ranks: what the sharding rules
    read (``axis_names``, ``shape``, ``size``), and the coordinates of the
    first rank (0 on every axis), so that a dry run cuts the blocks rank 0
    would hold. It has no groups: a collective on it raises."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str]):
        if len(sizes) != len(axis_names):
            raise ValueError(f"{len(sizes)} sizes for axes {tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = math.prod(self.shape.values())
        self.coords: Dict[str, int] = {a: 0 for a in self.axis_names}

    def coord(self, axes) -> int:
        """This rank's index along ``axes`` (one name, or a tuple of names
        read row-major in mesh order): its block of a dim sharded over them."""
        axes = _norm_axes(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def count(self, axes) -> int:
        """Ranks along ``axes``: the blocks of a dim sharded over them."""
        return math.prod(self.shape[a] for a in _norm_axes(axes))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


class Mesh(AbstractMesh):
    """A grid of the process group's ranks in row-major order over
    ``axis_names``, on a ``DeviceMesh``. backend: the process group's
    ("nccl": one rank a GPU; "gloo": CPU tensors, or CUDA tensors staged
    through host memory, see ``parallel/comm.py``)."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str], ranks=None):
        import numpy as np
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        super().__init__(sizes, axis_names)
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialised process group "
                               "(launch.mesh.init_distributed)")
        world = dist.get_world_size()
        ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
        if len(ranks) != self.size:
            raise ValueError(f"a mesh of {self.size} ranks over {len(ranks)}")
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        self.grid = np.asarray(ranks).reshape(tuple(self.shape.values()))
        where = np.argwhere(self.grid == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {self.rank} is not in the mesh {self.grid.tolist()}")
        self.coords: Dict[str, int] = dict(zip(self.axis_names, (int(c) for c in where[0])))
        self.device_mesh = DeviceMesh("cuda" if self.backend == "nccl" else "cpu",
                                      torch.as_tensor(self.grid),
                                      mesh_dim_names=self.axis_names)
        # every subset of two or more axes gets its groups here, collectively
        # (one axis: the DeviceMesh's own group)
        self._groups: Dict[Tuple[str, ...], object] = {}
        for k in range(2, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                lists = _subgroup_ranks(self.grid, self.axis_names, axes)
                mine, _ = dist.new_subgroups_by_enumeration(lists)
                self._groups[axes] = mine

    def rank_at(self, axes, index: int) -> int:
        """The rank at ``index`` along ``axes`` (``coord`` order) that shares
        this rank's coordinate on every other axis."""
        coords = dict(self.coords)
        for a in reversed(_norm_axes(axes)):
            coords[a] = index % self.shape[a]
            index //= self.shape[a]
        return int(self.grid[tuple(coords[a] for a in self.axis_names)])

    def group(self, axes):
        """The process group of the ranks that share this rank's coordinate
        on every axis but ``axes``, in ``coord`` order."""
        axes = tuple(a for a in self.axis_names if a in _norm_axes(axes))
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self._groups[axes]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, backend={self.backend!r}, rank={self.rank})"


def _norm_axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _subgroup_ranks(grid, axis_names, axes):
    """Rank lists of the subgroups along ``axes``: one list per coordinate
    of the other axes, each in row-major order over ``axes``."""
    import numpy as np
    order = [axis_names.index(a) for a in axes]
    rest = [i for i in range(len(axis_names)) if i not in order]
    moved = np.transpose(grid, rest + order)
    return [row.tolist() for row in moved.reshape(-1, math.prod(grid.shape[i] for i in order))]


def init_distributed(backend: Optional[str] = None, *, store_path: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None):
    """Join the process group, once per process: from ``torchrun``'s
    environment, or from a ``FileStore`` at ``store_path`` with ``rank`` and
    ``world_size`` given (without either, a group of this process alone, on a
    ``FileStore`` in a fresh temporary directory). backend: "nccl" (one rank a
    GPU: the rank's card is ``LOCAL_RANK``) or "gloo"; default "nccl" when a
    CUDA device is present. Returns the backend in use."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_backend()
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl" and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    if store_path is None and "RANK" in os.environ and rank is None:
        dist.init_process_group(backend, init_method="env://")
        return backend
    if store_path is None:
        import tempfile
        store_path = os.path.join(tempfile.mkdtemp(prefix="mesh_store_"), "store")
        rank, world_size = 0, 1
    if rank is None or world_size is None:
        raise ValueError("init_distributed(store_path=...) needs rank and world_size")
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    return backend


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes at its device counts (256 ranks,
    512 with ``multi_pod``) and axis names, with the model axis on the 8
    GPUs of one NVLink node: (32, 8) ('data', 'model') or (2, 16, 8)
    ('pod', 'data', 'model'). Raises unless the group holds exactly that
    many ranks."""
    shape = (2, 16, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, have = math.prod(shape), _world_size()
    if have != need:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} needs {need} ranks; "
                         f"the process group holds {have}")
    return Mesh(shape, axes)


def make_host_mesh(model_axis: int = 1) -> Mesh:
    """('data', 'model') over every rank of the group, model_axis of them on
    the model axis."""
    n = _world_size()
    if n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide {n} ranks")
    return Mesh((n // model_axis, model_axis), ("data", "model"))


def _mesh_sizes(spec: str, n_devices: int) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """The axes and sizes of a ``--mesh`` spec over ``n_devices`` (see
    ``parse_mesh``), with the reference's checks and messages."""
    axes, sizes, open_axis = [], [], None
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, size = entry.partition("=")
        if name not in _MESH_AXES:
            raise ValueError(
                f"unknown mesh axis {name!r} in --mesh {spec!r}; "
                f"choose from {_MESH_AXES}")
        if name in axes:
            raise ValueError(f"duplicate mesh axis {name!r} in {spec!r}")
        if size:
            if int(size) < 1:
                raise ValueError(
                    f"--mesh {spec!r}: axis size must be >= 1, got "
                    f"{name}={size}")
            axes.append(name), sizes.append(int(size))
        else:
            if open_axis is not None:
                raise ValueError(
                    f"--mesh {spec!r}: at most one axis may omit its size")
            axes.append(name), sizes.append(0)
            open_axis = len(axes) - 1
    if not axes:
        raise ValueError(f"empty --mesh spec {spec!r}")
    known = math.prod(s for s in sizes if s)
    if open_axis is not None:
        if n_devices % known:
            raise ValueError(
                f"--mesh {spec!r}: {known} explicit devices do not divide "
                f"the {n_devices} available")
        sizes[open_axis] = n_devices // known
    total = math.prod(sizes)
    if total != n_devices:
        # never silently serve on a subset of the ranks: a mesh that quietly
        # dropped some would misstate every comparison keyed on its size
        raise ValueError(
            f"--mesh {spec!r} carves {total} device(s) but {n_devices} "
            f"are available — add an open axis (e.g. 'data,{spec}') or "
            "match the sizes to the device count")
    return tuple(axes), tuple(sizes)


def parse_mesh(spec: str, devices=None):
    """A mesh from a ``--mesh`` flag value: comma-separated ``axis[=size]``
    entries, axes from {pod, data, model, stage} in that order. At most one
    axis may omit its size: it absorbs the ranks the explicit axes leave
    over. The sizes must use every rank of the group. Examples (8 ranks):

        --mesh data=2,model=4        -> Mesh (2, 4) ('data', 'model')
        --mesh data,model=4          -> data gets 8 // 4 = 2

    devices: the ranks to carve (default every rank of the process group;
    with a group, they must be all of it), or their number. Without an
    initialised process group the result is an ``AbstractMesh`` of the
    shape (``devices`` ranks, default 1)."""
    import torch.distributed as dist

    if isinstance(devices, int):
        n = devices
    elif devices is not None:
        n = len(list(devices))
    else:
        n = _world_size()
    axes, sizes = _mesh_sizes(spec, n)
    if not dist.is_initialized():
        return AbstractMesh(sizes, axes)
    if n != dist.get_world_size():
        raise ValueError(f"--mesh {spec!r} over {n} of the process group's "
                         f"{dist.get_world_size()} ranks: a mesh spans the whole group")
    return Mesh(sizes, axes)
