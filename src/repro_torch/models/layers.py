"""Elementary layers: RMSNorm and LayerNorm, rotate-half RoPE (over all or a
leading part of the head dims), SwiGLU and the GELU MLP. Plain functions
on tensors; parameters are dicts of tensors in the reference layout."""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """fp32 math, cast back. ``p["w"]`` broadcasts against x."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["w"].float()).to(x.dtype)


def layernorm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """fp32 math (the population variance), cast back. ``p["w"]`` and
    ``p["b"]`` broadcast against x."""
    x32 = x.float()
    xc = x32 - x32.mean(-1, keepdim=True)
    var = (xc * xc).mean(-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * p["w"].float() + p["b"].float()).to(x.dtype)


def norm(kind: str, x: torch.Tensor, p) -> torch.Tensor:
    """``cfg.norm``'s norm: "rmsnorm" or "layernorm"."""
    return rmsnorm(x, p) if kind == "rmsnorm" else layernorm(x, p)


def rope_cos_sin(positions: torch.Tensor, d_rot: int, theta: float):
    """positions: [..., T] int -> cos, sin [..., T, d_rot//2] (fp32)."""
    inv = 1.0 / (theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32,
                                        device=positions.device) / d_rot))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def rope_dims(hd: int, fraction: float = 1.0) -> int:
    """The rotary width: the leading int(hd * fraction) dims, rounded down
    to even."""
    d_rot = int(hd * fraction)
    return d_rot - d_rot % 2


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               fraction: float = 1.0) -> torch.Tensor:
    """x: [..., T, H, hd]; rotate-half over the leading ``rope_dims(hd,
    fraction)`` dims (the llama convention, also for chatglm's half), fp32
    math; the other dims pass through unchanged."""
    d_rot = rope_dims(x.shape[-1], fraction)
    x1, x2 = x[..., :d_rot].float().chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)
    if d_rot == x.shape[-1]:
        return out
    return torch.cat([out, x[..., d_rot:]], dim=-1)


def swiglu(x: torch.Tensor, p) -> torch.Tensor:
    """The llama FFN: (silu(x Wg) * x Wu) Wd, in the activation dtype."""
    g = torch.matmul(x, p["wg"])
    u = torch.matmul(x, p["wu"])
    return torch.matmul(torch.nn.functional.silu(g) * u, p["wd"])


def mlp_gelu(x: torch.Tensor, p) -> torch.Tensor:
    """The whisper FFN: gelu_tanh(x Wi + bi) Wo + bo, in the activation
    dtype; the biases where the layer has them."""
    h = torch.matmul(x, p["wi"])
    if "bi" in p:
        h = h + p["bi"]
    y = torch.matmul(torch.nn.functional.gelu(h, approximate="tanh"), p["wo"])
    return y + p["bo"] if "bo" in p else y


def ffn(act: str, x: torch.Tensor, p) -> torch.Tensor:
    """``cfg.act``'s dense FFN: "silu" (SwiGLU) or "gelu" (the GELU MLP)."""
    return swiglu(x, p) if act == "silu" else mlp_gelu(x, p)
