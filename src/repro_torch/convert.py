"""Move reference parameter and state trees into the port.

The reference's trees, converted leaf by leaf to numpy arrays, hold dicts
and tuples of arrays; the port uses the same layout with torch tensors.
Each float leaf keeps its role's dtype: the leaves that are fp32 whatever
the model dtype (Mamba's A_log and D; the MoE router; the recurrent state
A, z and h) stay fp32, the others (weights, the conv tail, KV caches) take
the model dtype.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

FP32_LEAVES = frozenset({"A_log", "D", "router", "A", "z", "h"})


def _to_torch(tree, device, dtype, name=""):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype, k) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to_torch(v, device, dtype, name) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.kind in "iub":
        return torch.from_numpy(np.array(arr)).to(device=device)
    # floats, bfloat16 among them (an extension dtype numpy calls kind 'V'),
    # go through float32
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
        device=device, dtype=torch.float32 if name in FP32_LEAVES else dtype)


def params_from_jax(np_tree: Dict, device, dtype=torch.float32) -> Dict:
    """Reference ``init_params`` tree (numpy leaves) -> port parameters on
    ``device``: A_log, D and the MoE router in fp32, every other float
    leaf in ``dtype``."""
    return _to_torch(np_tree, torch.device(device), dtype)


def state_from_jax(np_tree: Dict, device, dtype=torch.float32) -> Dict:
    """Reference executor/decode state tree (numpy leaves) -> port state:
    A, z and h in fp32, the conv tail and KV caches in ``dtype``; a scalar
    ``pos`` becomes a Python int."""
    out = _to_torch({k: v for k, v in np_tree.items() if k != "pos"},
                    torch.device(device), dtype)
    if "pos" in np_tree:
        pos = np.asarray(np_tree["pos"])
        out["pos"] = int(pos) if pos.ndim == 0 else torch.from_numpy(
            pos.astype(np.int64)).to(device)
    return out
