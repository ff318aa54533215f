"""Mamba-1 block (selective SSM) with carried state.

Layer-local recurrent state = (h [B, dI, dS] fp32, conv tail [B, d_conv-1,
dI] in the model dtype), carried across segments like ARMT's (A, z), so the
diagonal executor schedules Mamba layers with no special casing. The block
returns the new h and tail; the executors write them into the state's
buffers in place (``core/sequential.py`` ``apply_layer_``).

Every function takes one layer (x ``[B, T, D]``, parameter leaves as
``init_params`` makes them for one layer) or a band of G stacked layers (x
``[G, B, T, D]``, leaves ``[G, ...]``, state ``[G, B, ...]``): the
projections are then batched matmuls over ``[G, B*T, .]`` (the narrow x
projection one matmul per layer, so that a layer's bits do not depend on
the band), the conv and the elementwise work broadcast the per-layer
weights, and the scan is one kernel launch over all G*B rows
(``kernels/ops.py selective_scan_fused``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import SSMConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import rmsnorm


def mamba_dims(d_model: int, scfg: SSMConfig) -> Tuple[int, int]:
    """(d_inner, dt_rank)."""
    return scfg.expand * d_model, scfg.dt_rank or -(-d_model // 16)


def mamba_param_init(d_model: int, scfg: SSMConfig, n: int, nrm, dtype, device) -> Dict:
    """Stacked ``[n, ...]`` parameters of n layers in the reference's
    distributions; ``nrm(shape, scale)`` draws the normal ones. A_log and D
    stay fp32 whatever the dtype; A is the S4D-real init ``[1..dS]``."""
    dI, dtr = mamba_dims(d_model, scfg)
    dS, dc = scfg.d_state, scfg.d_conv
    A = torch.arange(1, dS + 1, dtype=torch.float32, device=device).expand(n, dI, dS)
    return {
        "in_proj": nrm((n, d_model, 2 * dI), d_model ** -0.5),
        "conv_w": nrm((n, dc, dI), dc ** -0.5),
        "conv_b": torch.zeros(n, dI, dtype=dtype, device=device),
        "x_proj": nrm((n, dI, dtr + 2 * dS), dI ** -0.5),
        "dt_proj": nrm((n, dtr, dI), dtr ** -0.5),
        "dt_bias": torch.full((n, dI), -4.6, dtype=dtype, device=device),  # softplus^-1(0.01)
        "A_log": torch.log(A).contiguous(),
        "D": torch.ones(n, dI, dtype=torch.float32, device=device),
        "out_proj": nrm((n, dI, d_model), dI ** -0.5),
    }


def mamba_state_init(batch: int, d_model: int, scfg: SSMConfig, dtype, device) -> Dict:
    dI, _ = mamba_dims(d_model, scfg)
    return {"h": torch.zeros(batch, dI, scfg.d_state, device=device),
            "conv": torch.zeros(batch, scfg.d_conv - 1, dI, dtype=dtype, device=device)}


def _proj(x, w):
    """x [B, T, K] @ w [K, N] (one layer), or x [G, B, T, K] @ w [G, K, N]
    (a band) as one batched matmul over [G, B*T, K]."""
    if w.dim() == 2:
        return torch.matmul(x, w)
    out = torch.matmul(x.reshape(w.shape[0], -1, x.shape[-1]), w)
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


def _proj_by_group(x, w):
    """``_proj`` as one matmul per layer of a band. For the x projection:
    its output is narrow (dt_rank + 2 d_state) and its K long, and the
    library's batched GEMM splits K by the band's group count (jamba's
    [16,384 x 544] at 1,152 rows: a group's bits at G = 2 are not its bits
    at G = 1), so a layer's projection would depend on the band. One call
    per layer is the sequential schedule's call."""
    if w.dim() == 2:
        return torch.matmul(x, w)
    xf = x.reshape(w.shape[0], -1, x.shape[-1])
    out = torch.stack([torch.matmul(xf[g], w[g]) for g in range(w.shape[0])])
    return out.reshape(x.shape[:-1] + (w.shape[-1],))


def _bcast(v, x):
    """A per-channel leaf ([dI], or [G, dI] for a band) shaped to broadcast
    against x [(G,) B, T, dI]."""
    return v.reshape(v.shape[:-1] + (1,) * (x.dim() - v.dim()) + v.shape[-1:])


def _causal_conv(xi, tail, w, b):
    """Depthwise causal conv1d. xi: [.., T, dI]; tail: [.., dc-1, dI] (the
    previous inputs); w: [(G,) dc, dI]; b: [(G,) dI] -> (y [.., T, dI],
    new tail: a view, which the executors copy into the state's buffer)."""
    dc, T = w.shape[-2], xi.shape[-2]
    xp = torch.cat([tail.to(xi.dtype), xi], dim=-2)            # [.., T+dc-1, dI]
    y = xp[..., 0:T, :] * _bcast(w.select(-2, 0), xi)
    for j in range(1, dc):
        y = y + xp[..., j:j + T, :] * _bcast(w.select(-2, j), xi)
    return y + _bcast(b, xi), xp[..., T:T + dc - 1, :]


def _ssm_inputs(xc, p, scfg: SSMConfig):
    """xc: [.., T, dI] (post-conv, post-silu) -> (dt [.., T, dI], the raw
    dt_proj output in xc's dtype, whose bias and softplus the scan applies;
    B and C [.., T, dS] fp32). B and C are column slices of one fp32 copy of
    the x_proj output, which the scan kernel reads through their strides."""
    dS = scfg.d_state
    dtr = p["dt_proj"].shape[-2]
    proj = _proj_by_group(xc, p["x_proj"])                      # [.., T, dtr + 2dS]
    dt = _proj(proj[..., :dtr], p["dt_proj"])
    bc = proj[..., dtr:].float()
    return dt, bc[..., :dS], bc[..., dS:]


def selective_scan(xc, dt, Bt, Ct, A_log, D, h0, *, dt_bias=None, z=None):
    """h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t;  y_t = C_t . h_t + D x_t, on
    the ``mamba_scan`` kernel (the plain version for a CPU tensor), dt taken
    as softplus(dt + dt_bias) and y gated by silu(z) when those are given.
    Returns (y shaped like xc: fp32, or xc's dtype gated; h_T fp32)."""
    return kops.selective_scan_fused(xc, dt, Bt, Ct, A_log, D, h0, dt_bias=dt_bias, z=z)


def mamba_mixer(x, p, scfg: SSMConfig, state: Dict):
    """The mixer over a segment. x: [(G,) B, T, D] -> (y like x, new state
    {h, conv}). The dt softplus and the output gate run inside the scan."""
    dI = p["in_proj"].shape[-1] // 2
    xz = _proj(x, p["in_proj"])
    xi, z = xz[..., :dI], xz[..., dI:]
    xc, new_tail = _causal_conv(xi, state["conv"], p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    dt, Bt, Ct = _ssm_inputs(xc, p, scfg)
    y, hT = selective_scan(xc, dt, Bt, Ct, p["A_log"], p["D"], state["h"],
                           dt_bias=p["dt_bias"], z=z)
    return _proj(y, p["out_proj"]), {"h": hT, "conv": new_tail}


def mamba_block(p, x, scfg: SSMConfig, state: Dict):
    """The ``mamba`` block: pre-norm mixer plus the residual (no FFN), for
    one layer or a band. p: {ln1, mixer}; state: the layer's {h, conv} (any
    other leaves pass through) -> (y like x, new state)."""
    mix, new_ssm = mamba_mixer(rmsnorm(x, {"w": _bcast(p["ln1"]["w"], x)}), p["mixer"],
                               scfg, {"h": state["h"], "conv": state["conv"]})
    return x + mix, {**state, **new_ssm}


def mamba_decode_step(x, p, scfg: SSMConfig, state: Dict):
    """Single-token decode. x: [B, 1, D] -> (y [B, 1, D], new state)."""
    return mamba_mixer(x, p, scfg, state)
