"""Mamba-1 selective scan.

Replaces the Pallas kernel ``mamba_scan`` (repro/kernels/mamba_scan.py:44,
body ``_scan_kernel``): per row and channel, ``h_t = exp(dt_t A) h_{t-1} +
(dt_t x_t) B_t`` and ``y_t = h_t . C_t + D x_t`` with ``A = -exp(A_log)``,
all in fp32, h kept on chip for the whole sequence. The rows may be a band
of G layers (N = G * batch rows, row n taking ``A_log[n // batch]`` and
``D[n // batch]``), so one launch scans a whole diagonal step. CUDA source:
``csrc/mamba_scan.cu``; plain version: ``mamba_scan_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mamba_scan_ref as mamba_scan_plain

launches = 0   # kernel launches since the last reset

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
D_STATES = (4, 8, 16)   # the kernel keeps h[dS] in registers, one build per dS


def mamba_scan(x, dt, Bt, Ct, A_log, D, h0):
    """x/dt: [N,T,dI]; Bt/Ct: [N,T,dS]; A_log: [dI,dS] or [G,dI,dS]; D:
    [dI] or [G,dI]; h0: [N,dI,dS] -> (y [N,T,dI], hT [N,dI,dS]), fp32.

    x may be fp32 or bf16, everything else is fp32; x, dt, Bt and Ct are
    read through their row and token strides (last dim contiguous). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    global launches
    if x.device.type == "cpu":
        return mamba_scan_plain(x, dt, Bt, Ct, A_log, D, h0)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan: unsupported device {x.device}")
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"mamba_scan: x {tuple(x.shape)} dt {tuple(dt.shape)}")
    N, T, dI = x.shape
    dS = A_log.shape[-1]
    G = A_log.shape[0] if A_log.dim() == 3 else 1
    if (Bt.shape != (N, T, dS) or Ct.shape != (N, T, dS)
            or A_log.shape[-2:] != (dI, dS) or A_log.dim() not in (2, 3)
            or D.shape != A_log.shape[:-1] or h0.shape != (N, dI, dS) or N % G):
        raise ValueError(f"mamba_scan: x {tuple(x.shape)} B {tuple(Bt.shape)} C "
                         f"{tuple(Ct.shape)} A_log {tuple(A_log.shape)} D "
                         f"{tuple(D.shape)} h0 {tuple(h0.shape)}")
    if dS not in D_STATES:
        raise ValueError(f"mamba_scan: d_state {dS} not in {D_STATES}")
    if x.dtype not in _DTYPE or any(t.dtype != torch.float32
                                    for t in (dt, Bt, Ct, A_log, D, h0)):
        raise ValueError("mamba_scan: x must be fp32 or bf16 and dt, B, C, A_log, "
                         "D, h0 fp32")
    if any(t.stride(-1) != 1 for t in (x, dt, Bt, Ct)):
        raise ValueError("mamba_scan: the last dim of x, dt, B and C must be contiguous")
    if not all(t.is_contiguous() for t in (A_log, D, h0)):
        raise ValueError("mamba_scan: A_log, D and h0 must be contiguous")
    if not all(t.device == x.device for t in (dt, Bt, Ct, A_log, D, h0)):
        raise ValueError("mamba_scan: operands on different devices")
    y = torch.empty(N, T, dI, dtype=torch.float32, device=x.device)
    hT = torch.empty(N, dI, dS, dtype=torch.float32, device=x.device)
    if N * dI == 0:
        return y, hT
    launches += 1
    code = build.lib().mamba_scan_launch(
        x.data_ptr(), dt.data_ptr(), Bt.data_ptr(), Ct.data_ptr(), A_log.data_ptr(),
        D.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(), N, T, dI, dS, G,
        x.stride(0), x.stride(1), dt.stride(0), dt.stride(1), Bt.stride(0), Bt.stride(1),
        Ct.stride(0), Ct.stride(1), _DTYPE[x.dtype], build.stream_ptr(x))
    build.check(code, "mamba_scan")
    return y, hT
