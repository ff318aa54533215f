"""Elementary layers: RMSNorm, rotate-half RoPE, SwiGLU. Plain functions
on tensors; parameters are dicts of tensors in the reference layout."""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """fp32 math, cast back. ``p["w"]`` broadcasts against x."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["w"].float()).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, d_rot: int, theta: float):
    """positions: [..., T] int -> cos, sin [..., T, d_rot//2] (fp32)."""
    inv = 1.0 / (theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32,
                                        device=positions.device) / d_rot))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., T, H, hd]; rotate-half over the full head dim, fp32 math."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, p) -> torch.Tensor:
    """The llama FFN: (silu(x Wg) * x Wu) Wd, in the activation dtype."""
    g = torch.matmul(x, p["wg"])
    u = torch.matmul(x, p["wu"])
    return torch.matmul(torch.nn.functional.silu(g) * u, p["wd"])
