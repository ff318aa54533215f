"""Int8 error-feedback gradient compression for a slow reduction hop (the
reference's ``optim/compression.py``, function for function).

Gradients tolerate aggressive quantization if the quantization error is
fed back into the next step (error feedback, EF-SGD). Per leaf:

  g_eff = g + e_prev                 (error feedback)
  q, scale = quantize_int8(g_eff)    (per-tile max-abs scaling)
  e_next = g_eff - dequant(q, scale) (local; carried by the caller)
  sync: an all-gather of q (1 byte an element) and the scales (fp32 a
        tile) in place of a bf16 or fp32 all-reduce of the gradient.

``compressed_psum(x, mesh, axis)`` is the sync over a mesh axis: the int8
blocks and scales all-gathered, each rank's dequantized and summed in
rank order (an int8 sum would overflow). Like the reference, the port
wires it into no train step.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.parallel import comm

TILE = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile symmetric int8 quantization along the last axis -> (q int8
    [..., n padded to a multiple of TILE], scale fp32 [..., n / TILE])."""
    shape = x.shape
    n = shape[-1]
    pad = (-n) % TILE
    xf = x.float()
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    t = xf.reshape(shape[:-1] + (-1, TILE))
    scale = t.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(t / scale[..., None]), -127, 127).to(torch.int8)
    return q.reshape(shape[:-1] + (n + pad,)), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 [..., n] from ``quantize_int8``'s (q, scale)."""
    t = q.reshape(q.shape[:-1] + (-1, TILE)).float()
    return (t * scale[..., None]).reshape(q.shape[:-1] + (-1,))[..., :n]


def ef_compress(g: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback round trip (local) -> (g_hat in g's dtype, the new
    fp32 error)."""
    g_eff = g.float() + err
    q, s = quantize_int8(g_eff)
    g_hat = dequantize_int8(q, s, g.shape[-1]).to(g.dtype)
    return g_hat, g_eff - g_hat.float()


def compressed_psum(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The quantized sum of x over the ranks along ``axis``: every rank's
    int8 blocks and scales all-gathered, dequantized and summed in rank
    order, in x's dtype (detached)."""
    n = x.shape[-1]
    q, s = quantize_int8(x.detach())
    q_all = comm.all_gather(q[None], mesh, axis, 0)
    s_all = comm.all_gather(s[None], mesh, axis, 0)
    return dequantize_int8(q_all, s_all, n).sum(dim=0).to(x.dtype)


def wire_bytes_ratio(n_devices: int) -> float:
    """Wire bytes of ``compressed_psum`` against a bf16 ring all-reduce (a
    device)."""
    ag = (n_devices - 1) / n_devices * (1 + 4 / TILE)     # int8 + scales
    ar = 2 * (n_devices - 1) / n_devices * 2              # bf16 ring all-reduce
    return ag / ar
