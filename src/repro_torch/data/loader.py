"""Host batches (numpy) onto the device the model runs on."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Each array of a batch as a tensor on ``device`` (same dtype)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
