"""Mamba-1 selective scan, with the mixer's dt prologue and gate epilogue.

Replaces the Pallas kernel ``mamba_scan`` (repro/kernels/mamba_scan.py:44,
body ``_scan_kernel``): per row and channel, ``h_t = exp(dt_t A) h_{t-1} +
(dt_t x_t) B_t`` and ``y_t = h_t . C_t + D x_t`` with ``A = -exp(A_log)``,
all in fp32, h kept on chip for the whole sequence. The rows may be a band
of G layers (N = G * batch rows, row n taking ``A_log[n // batch]`` and
``D[n // batch]``), so one launch scans a whole diagonal step.

Two keywords, given together, take in the elementwise work the mixer does
around the scan (the fused form): ``dt_bias=`` makes dt the raw
``dt_proj`` output (in x's dtype), the scan using ``softplus(dt +
dt_bias)`` in fp32, and ``z=`` gates the output, which comes back in x's
dtype as ``y.to(dtype) * silu(z)`` with PyTorch eager's roundings. Without
them the function is the TPU kernel's. CUDA source:
``csrc/mamba_scan.cu``; plain version: ``mamba_scan_plain``.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mamba_scan_ref as mamba_scan_plain

launches = 0   # kernel launches since the last reset
build.count_launches(sys.modules[__name__], "launches")

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
D_STATES = (4, 8, 16)   # the kernel keeps h[dS] in registers, one build per dS


def _strides(t):
    """(row, token) strides of a [N,T,.] operand, 0 for a dim of size 1
    (PyTorch leaves those arbitrary, and the kernel checks alignment on
    them)."""
    return tuple(t.stride(i) if t.shape[i] > 1 else 0 for i in (0, 1))


def mamba_scan(x, dt, Bt, Ct, A_log, D, h0, *, dt_bias=None, z=None):
    """x: [N,T,dI]; dt: [N,T,dI]; Bt/Ct: [N,T,dS]; A_log: [dI,dS] or
    [G,dI,dS]; D: [dI] or [G,dI]; h0: [N,dI,dS] -> (y [N,T,dI], hT
    [N,dI,dS] fp32).

    x may be fp32 or bf16; Bt, Ct, A_log, D and h0 are fp32. Without the
    keywords dt is fp32 (post-softplus) and y fp32. With ``dt_bias`` (shaped
    like D, fp32 or x's dtype) and ``z`` ([N,T,dI] in x's dtype), both or
    neither, dt is the raw dt in x's dtype and y the gated output in x's
    dtype.
    x, dt, z, Bt and Ct are read through their row and token strides (last
    dim contiguous). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    global launches
    if (dt_bias is None) != (z is None):
        raise ValueError("mamba_scan: dt_bias and z go together (the fused form) or not at all")
    if x.device.type == "cpu":
        return mamba_scan_plain(x, dt, Bt, Ct, A_log, D, h0, dt_bias=dt_bias, z=z)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan: unsupported device {x.device}")
    if x.dim() != 3 or dt.shape != x.shape or (z is not None and z.shape != x.shape):
        raise ValueError(f"mamba_scan: x {tuple(x.shape)} dt {tuple(dt.shape)}"
                         + (f" z {tuple(z.shape)}" if z is not None else ""))
    N, T, dI = x.shape
    dS = A_log.shape[-1]
    G = A_log.shape[0] if A_log.dim() == 3 else 1
    if (Bt.shape != (N, T, dS) or Ct.shape != (N, T, dS)
            or A_log.shape[-2:] != (dI, dS) or A_log.dim() not in (2, 3)
            or D.shape != A_log.shape[:-1] or h0.shape != (N, dI, dS) or N % G
            or (dt_bias is not None and dt_bias.shape != D.shape)):
        raise ValueError(f"mamba_scan: x {tuple(x.shape)} B {tuple(Bt.shape)} C "
                         f"{tuple(Ct.shape)} A_log {tuple(A_log.shape)} D "
                         f"{tuple(D.shape)} h0 {tuple(h0.shape)}"
                         + (f" dt_bias {tuple(dt_bias.shape)}" if dt_bias is not None else ""))
    if dS not in D_STATES:
        raise ValueError(f"mamba_scan: d_state {dS} not in {D_STATES}")
    dt_dtype = x.dtype if z is not None else torch.float32
    if (x.dtype not in _DTYPE or dt.dtype != dt_dtype
            or any(t.dtype != torch.float32 for t in (Bt, Ct, A_log, D, h0))
            or (z is not None and (dt_bias.dtype not in (torch.float32, x.dtype)
                                   or z.dtype != x.dtype))):
        raise ValueError("mamba_scan: x must be fp32 or bf16; B, C, A_log, D, h0 fp32; dt "
                         "fp32, or x's dtype when fused; dt_bias fp32 or x's dtype; z x's "
                         "dtype")
    if any(t.stride(-1) != 1 for t in (x, dt, Bt, Ct) + ((z,) if z is not None else ())):
        raise ValueError("mamba_scan: the last dim of x, dt, z, B and C must be contiguous")
    if not all(t.is_contiguous() for t in (A_log, D, h0)
               + ((dt_bias,) if dt_bias is not None else ())):
        raise ValueError("mamba_scan: A_log, D, dt_bias and h0 must be contiguous")
    if not all(t.device == x.device for t in (dt, Bt, Ct, A_log, D, h0)
               + tuple(t for t in (dt_bias, z) if t is not None)):
        raise ValueError("mamba_scan: operands on different devices")
    y = torch.empty(N, T, dI, dtype=x.dtype if z is not None else torch.float32,
                    device=x.device)
    hT = torch.empty(N, dI, dS, dtype=torch.float32, device=x.device)
    if N * dI == 0:
        return y, hT
    launches += 1
    code = build.lib().mamba_scan_launch(
        x.data_ptr(), dt.data_ptr(), Bt.data_ptr(), Ct.data_ptr(), A_log.data_ptr(),
        D.data_ptr(), h0.data_ptr(), dt_bias.data_ptr() if dt_bias is not None else None,
        z.data_ptr() if z is not None else None, y.data_ptr(), hT.data_ptr(),
        N, T, dI, dS, G, *_strides(x), *_strides(dt), *_strides(Bt), *_strides(Ct),
        *(_strides(z) if z is not None else (0, 0)), _DTYPE[x.dtype],
        int(dt_bias is not None and dt_bias.dtype == torch.bfloat16), build.stream_ptr(x))
    build.check(code, "mamba_scan")
    return y, hT
