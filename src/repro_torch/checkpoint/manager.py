"""Checkpoints on disk: step checkpoints of training, and named blobs, the
serving state store's spill tier (``serve/state_store.py``).

A step checkpoint is a tree of tensors (the train state: params and the
optimizer's moments and step) under ``<dir>/step_<n>/``: one
``leaf_<i>.npy`` per leaf in the tree's order and a ``manifest.json`` with
each leaf's path, shape, dtype and a sha256 of its bytes (truncated),
checked on restore. It is written into ``<dir>/.tmp_step_<n>`` and renamed
into place (atomic on POSIX), so a crash mid-save never corrupts the latest
checkpoint; the leaves are copied to the host before ``save`` returns and
written by a background thread (``async_save``; ``wait`` joins it), and
only the newest ``keep`` checkpoints stay.

A named blob is a flat ``{key: tensor}`` dict stored under an arbitrary
string name, in ``<dir>/named/<digest of the name>/``: one ``leaf_<i>.npy``
per key and a ``manifest.json`` with each leaf's key, shape, dtypes and a
sha256 of its bytes (truncated), checked on restore. A save writes into
``.tmp_<digest>`` and renames it into place (atomic on POSIX), so a crash
mid-save never leaves a half-written blob under the name.

numpy has no bfloat16: a bf16 leaf is stored as its raw bits, a uint16
array, with the torch dtype in the manifest, and viewed back on restore, so
the round trip is bitwise for every dtype.

"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.utils import tree_flatten_with_path, tree_leaves, tree_unflatten

# torch dtypes numpy lacks, stored as raw bits of the same width
_RAW = {torch.bfloat16: (torch.int16, np.uint16)}


def _hash(a: np.ndarray) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def _to_numpy(t) -> tuple:
    """(host array, torch dtype name) of a tensor (or array) leaf."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t))
    t = t.detach().cpu().contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype in _RAW:
        view, np_dtype = _RAW[t.dtype]
        return t.view(view).numpy().view(np_dtype), name
    return t.numpy(), name


def _from_numpy(a: np.ndarray, name: str) -> torch.Tensor:
    dtype = getattr(torch, name)
    if dtype in _RAW:
        view, _ = _RAW[dtype]
        return torch.from_numpy(a.view(np.dtype(str(view).removeprefix("torch.")))).view(dtype)
    return torch.from_numpy(a)


def _write_leaves(tmp: Path, leaves, manifest: Dict) -> None:
    """Each (path, tensor) as ``leaf_<i>.npy`` in ``tmp``, and the manifest
    with their paths, shapes, dtypes and hashes."""
    manifest["leaves"] = []
    for i, (key, leaf) in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        np.save(tmp / f"leaf_{i}.npy", arr)
        manifest["leaves"].append({"i": i, "path": key, "shape": list(arr.shape),
                                   "dtype": dtype, "sha": _hash(arr)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))


def _read_leaves(d: Path, verify: bool, what: str):
    """The manifest's leaves of directory d as [(path, CPU tensor)]."""
    manifest = json.loads((d / "manifest.json").read_text())
    out = []
    for leaf in manifest["leaves"]:
        arr = np.load(d / f"leaf_{leaf['i']}.npy")
        if verify and _hash(arr) != leaf["sha"]:
            raise IOError(f"{what} corruption at {leaf['path']}")
        out.append((leaf["path"], _from_numpy(arr, leaf["dtype"])))
    return out


class CheckpointManager:
    """Step checkpoints and named blobs under ``directory`` (created if
    missing). keep: step checkpoints kept (the newest; 0 keeps all);
    async_save: ``save`` hands the write to a background thread."""

    def __init__(self, directory, *, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # -------------------------------------------------------- step checkpoints
    def save(self, step: int, tree: Any, *, block: bool = False) -> None:
        """Checkpoint ``tree`` as step ``step``. Its leaves are copied to the
        host first (so the caller may go on updating them); the write runs
        on a background thread unless ``block`` or not ``async_save``. A
        save waits for the previous one."""
        host = [(path, leaf.detach().to("cpu", copy=True) if isinstance(leaf, torch.Tensor)
                 else leaf) for path, leaf in tree_flatten_with_path(tree)]
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(target=self._write, args=(step, host),
                                            daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def _write(self, step: int, host) -> None:
        tmp, final = self.dir / f".tmp_step_{step}", self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        _write_leaves(tmp, host, {"step": step, "time": time.time()})
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        """Join the background write, if one is running."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def all_steps(self):
        """The steps with a complete checkpoint, ascending."""
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if (p / "manifest.json").exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None, *, verify: bool = True) -> Any:
        """The checkpoint of ``step`` (default: the latest) as a tree of
        ``like``'s structure, each leaf on the device of ``like``'s leaf
        (the saved dtype kept). verify: check each leaf's hash (IOError on
        a mismatch)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        arrays = _read_leaves(self.dir / f"step_{step}", verify, f"checkpoint step_{step}")
        likes = tree_leaves(like)
        if len(likes) != len(arrays):
            raise ValueError(f"checkpoint has {len(arrays)} leaves, expected {len(likes)}")
        return tree_unflatten(like, [a.to(l.device) if isinstance(l, torch.Tensor) else a
                                     for (_, a), l in zip(arrays, likes)])

    # ------------------------------------------------------------- named blobs

    def _named_dir(self, name: str) -> Path:
        digest = hashlib.sha256(name.encode()).hexdigest()[:24]
        return self.dir / "named" / digest

    def save_named(self, name: str, arrays: Dict) -> None:
        """Persist a flat {key: tensor or ndarray} dict under ``name``,
        replacing a blob of that name. Synchronous: the stores spill on
        eviction, not per step."""
        final = self._named_dir(name)
        tmp = final.parent / f".tmp_{final.name}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        _write_leaves(tmp, [(key, leaf) for key, leaf in arrays.items()],
                      {"name": name, "time": time.time()})
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)

    def has_named(self, name: str) -> bool:
        return (self._named_dir(name) / "manifest.json").exists()

    def restore_named(self, name: str, *, verify: bool = True) -> Dict[str, torch.Tensor]:
        """The blob ``name`` as a {key: CPU tensor} dict, in save order, each
        leaf in the dtype it was saved in. verify: check each leaf's hash
        (raises IOError on a mismatch)."""
        d = self._named_dir(name)
        if not (d / "manifest.json").exists():
            raise FileNotFoundError(f"no named blob {name!r} in {self.dir}")
        return dict(_read_leaves(d, verify, f"blob {name!r}"))

    def delete_named(self, name: str) -> None:
        shutil.rmtree(self._named_dir(name), ignore_errors=True)
