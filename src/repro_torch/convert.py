"""Move reference parameter and state trees into the port.

The reference's trees, converted leaf by leaf to numpy arrays, hold dicts
and tuples of arrays; the port uses the same layout with torch tensors.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to_torch(v, device, dtype) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.kind == "f":
        # bfloat16 and other numpy extension floats go through float32
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=device, dtype=dtype)
    return torch.from_numpy(np.array(arr)).to(device=device)


def params_from_jax(np_tree: Dict, device, dtype=torch.float32) -> Dict:
    """Reference ``init_params`` tree (numpy leaves) -> port parameters in
    ``dtype`` on ``device``."""
    return _to_torch(np_tree, torch.device(device), dtype)


def state_from_jax(np_tree: Dict, device) -> Dict:
    """Reference executor/decode state tree (numpy leaves) -> port state;
    A/z stay float32, a scalar ``pos`` becomes a Python int."""
    out = _to_torch({k: v for k, v in np_tree.items() if k != "pos"},
                    torch.device(device), torch.float32)
    if "pos" in np_tree:
        pos = np.asarray(np_tree["pos"])
        out["pos"] = int(pos) if pos.ndim == 0 else torch.from_numpy(
            pos.astype(np.int64)).to(device)
    return out
