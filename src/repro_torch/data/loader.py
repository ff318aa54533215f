"""Host batches (numpy) onto the device the model runs on: whole
(``to_device``), or this rank's rows over a mesh's DP axes
(``shard_batch``, the reference's placement by ``batch_specs``)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.parallel import sharding as shd


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Each array of a batch as a tensor on ``device`` (same dtype)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def shard_batch(batch: Dict[str, np.ndarray], mesh, device, *,
                microbatches: int = 1) -> Dict[str, torch.Tensor]:
    """This rank's rows of a host batch (arrays whose dim 0 is the batch B)
    as tensors on ``device``; without a mesh, ``to_device``.

    The rows split over ``sharding.batch_axes``: the largest prefix of the
    DP axes whose product divides the rows of a microbatch (n = B /
    microbatches), this rank taking its block of each microbatch's rows,
    microbatch by microbatch, so that its microbatch i is its share of the
    reference's global rows [i n, (i + 1) n) (with one microbatch, the
    block of ``batch_specs``). Where no DP axis divides n, every rank
    takes all the rows, as the reference replicates them (``lm_loss(mesh=)``
    then counts them once)."""
    if mesh is None:
        return to_device(batch, device)
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into {microbatches} microbatches")
        n = B // microbatches
        ax = shd.batch_axes(mesh, n, leaf=k)
        if ax is not None:
            w = n // mesh.count(ax)
            lo = mesh.coord(ax) * w
            v = np.concatenate([v[i * n + lo:i * n + lo + w] for i in range(microbatches)])
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out
