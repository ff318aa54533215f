"""Named blobs on disk: the serving state store's spill tier
(``serve/state_store.py``).

A named blob is a flat ``{key: tensor}`` dict stored under an arbitrary
string name, in ``<dir>/named/<digest of the name>/``: one ``leaf_<i>.npy``
per key and a ``manifest.json`` with each leaf's key, shape, dtypes and a
sha256 of its bytes (truncated), checked on restore. A save writes into
``.tmp_<digest>`` and renames it into place (atomic on POSIX), so a crash
mid-save never leaves a half-written blob under the name.

numpy has no bfloat16: a bf16 leaf is stored as its raw bits, a uint16
array, with the torch dtype in the manifest, and viewed back on restore, so
the round trip is bitwise for every dtype.

Step checkpoints of training (``save``/``restore`` in the reference) are
not ported yet; they come with the training loop.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

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


class CheckpointManager:
    """Named blobs under ``directory`` (created if missing)."""

    def __init__(self, directory):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

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
        manifest = {"name": name, "time": time.time(), "leaves": []}
        for i, (key, leaf) in enumerate(arrays.items()):
            arr, dtype = _to_numpy(leaf)
            np.save(tmp / f"leaf_{i}.npy", arr)
            manifest["leaves"].append({"i": i, "path": key, "shape": list(arr.shape),
                                       "dtype": dtype, "sha": _hash(arr)})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
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
        manifest = json.loads((d / "manifest.json").read_text())
        out = {}
        for leaf in manifest["leaves"]:
            arr = np.load(d / f"leaf_{leaf['i']}.npy")
            if verify and _hash(arr) != leaf["sha"]:
                raise IOError(f"blob corruption at {name!r}/{leaf['path']}")
            out[leaf["path"]] = _from_numpy(arr, leaf["dtype"])
        return out

    def delete_named(self, name: str) -> None:
        shutil.rmtree(self._named_dir(name), ignore_errors=True)
