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

Under gradients (an operand that requires one) the call goes through
``MambaScanFn``, in either form: forward, the kernel also keeping the
state before every ``CHUNK``-th token; backward, the reverse scan kernel
(``csrc/mamba_scan_bwd.cu``, counted in ``bwd_launches``) from those
states, or on the CPU its plain version ``grad.mamba_scan_bwd_plain``. It
gives the gradients of x, dt (the raw dt in the fused form), B, C, A_log,
D, h0, dt_bias and z.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.kernels import build, grad
from repro_torch.kernels.grad import needs_grad
from repro_torch.kernels.ref import mamba_scan_ref as mamba_scan_plain

launches = 0       # forward kernel launches since the last reset
bwd_launches = 0   # backward kernel launches since the last reset
build.count_launches(sys.modules[__name__], "launches", "bwd_launches")

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
D_STATES = (4, 8, 16)   # the kernel keeps h[dS] in registers, one build per dS
CHUNK = 128             # tokens between two states a forward under gradients keeps
# the backward's buffers are sized by these; its launch refuses any but the
# BTH and SUB csrc/mamba_scan_bwd.cu was built with
BWD_BLOCK = 128         # channels of a backward block: one dB/dC partial each
BWD_SUB = 4             # the backward's register-held sub-chunk (the scratch's unit)


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
    launches the kernel or raises. With gradients on and an operand that
    requires one, the call goes through ``MambaScanFn``."""
    if (dt_bias is None) != (z is None):
        raise ValueError("mamba_scan: dt_bias and z go together (the fused form) or not at all")
    if needs_grad(x, dt, Bt, Ct, A_log, D, h0, dt_bias, z):
        return MambaScanFn.apply(x, dt, Bt, Ct, A_log, D, h0, dt_bias, z)
    return _mamba_scan(x, dt, Bt, Ct, A_log, D, h0, dt_bias=dt_bias, z=z)[:2]


class MambaScanFn(torch.autograd.Function):
    """``mamba_scan`` under autograd. Forward: the kernel, keeping the state
    before every CHUNK-th token (on the CPU the plain version, keeping
    nothing). Backward: the reverse scan kernel from those states, or on
    the CPU ``grad.mamba_scan_bwd_plain``; both recompute the states
    between two kept ones, so the saved tensors are the operands and the
    kept states only."""

    @staticmethod
    def forward(ctx, x, dt, Bt, Ct, A_log, D, h0, dt_bias, z):
        y, hT, hs = _mamba_scan(x, dt, Bt, Ct, A_log, D, h0, dt_bias=dt_bias, z=z, keep=True)
        ctx.save_for_backward(x, dt, Bt, Ct, A_log, D, h0, dt_bias, z, hs)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, Bt, Ct, A_log, D, h0, dt_bias, z, hs = ctx.saved_tensors
        if x.device.type == "cpu":
            return grad.mamba_scan_bwd_plain(x, dt, Bt, Ct, A_log, D, h0, dy, dhT,
                                             dt_bias=dt_bias, z=z)
        return mamba_scan_bwd(x, dt, Bt, Ct, A_log, D, h0, hs, dy, dhT, dt_bias=dt_bias, z=z)


def _mamba_scan(x, dt, Bt, Ct, A_log, D, h0, *, dt_bias=None, z=None, keep=False):
    """The forward -> (y, hT, the kept states [N, ceil(T / CHUNK), dI, dS]
    fp32 when ``keep`` on the card, else None)."""
    global launches
    if x.device.type == "cpu":
        return mamba_scan_plain(x, dt, Bt, Ct, A_log, D, h0, dt_bias=dt_bias, z=z) + (None,)
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
    hs = (torch.empty(N, -(-T // CHUNK), dI, dS, dtype=torch.float32, device=x.device)
          if keep else None)
    if N * dI == 0:
        return y, hT, hs
    launches += 1
    code = build.lib().mamba_scan_launch(
        x.data_ptr(), dt.data_ptr(), Bt.data_ptr(), Ct.data_ptr(), A_log.data_ptr(),
        D.data_ptr(), h0.data_ptr(), dt_bias.data_ptr() if dt_bias is not None else None,
        z.data_ptr() if z is not None else None, y.data_ptr(), hT.data_ptr(),
        hs.data_ptr() if hs is not None else None, CHUNK,
        N, T, dI, dS, G, *_strides(x), *_strides(dt), *_strides(Bt), *_strides(Ct),
        *(_strides(z) if z is not None else (0, 0)), _DTYPE[x.dtype],
        int(dt_bias is not None and dt_bias.dtype == torch.bfloat16), build.stream_ptr(x))
    build.check(code, "mamba_scan")
    return y, hT, hs


def mamba_scan_bwd(x, dt, Bt, Ct, A_log, D, h0, hs, dy, dhT, *, dt_bias=None, z=None):
    """The backward kernel on the card: gradients of ``mamba_scan`` given dy
    [N,T,dI] (y's dtype) and dhT [N,dI,dS] (None: zero), from the states
    ``hs`` a forward kept -> (dx, ddt, dB, dC, dA_log, dD, dh0, ddt_bias,
    dz), each shaped and typed like its operand (None for dt_bias and z in
    the TPU form). The kernel writes the blocks' dB/dC partials and per-row
    dA_log, dD and d dt_bias; their sums here are fixed-order reductions,
    so the bits are the same in every run."""
    global bwd_launches
    N, T, dI = x.shape
    dS = A_log.shape[-1]
    G = A_log.shape[0] if A_log.dim() == 3 else 1
    fused = z is not None
    x, dt, Bt, Ct, dy = (t.contiguous() for t in (x, dt, Bt, Ct, dy))
    z = z.contiguous() if fused else None
    dhT = dhT.contiguous() if dhT is not None else None
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty(N, T, dI, dtype=x.dtype, device=dev)
    ddt = torch.empty(N, T, dI, dtype=dt.dtype, device=dev)
    dz = torch.empty(N, T, dI, dtype=z.dtype, device=dev) if fused else None
    dbc = torch.empty(-(-dI // BWD_BLOCK), N, T, 2 * dS, **f32)
    dA = torch.empty(N, dI, dS, **f32)
    dDr = torch.empty(N, dI, **f32)
    dbr = torch.empty(N, dI, **f32) if fused else None
    dh0 = torch.empty(N, dI, dS, **f32)
    mid = torch.empty(N, CHUNK // BWD_SUB, dS, dI, **f32)
    bwd_launches += 1
    code = build.lib().mamba_scan_bwd_launch(
        x.data_ptr(), dt.data_ptr(), Bt.data_ptr(), Ct.data_ptr(), A_log.data_ptr(),
        D.data_ptr(), dt_bias.data_ptr() if fused else None, z.data_ptr() if fused else None,
        dy.data_ptr(), hs.data_ptr(), dhT.data_ptr() if dhT is not None else None,
        dx.data_ptr(), ddt.data_ptr(), dz.data_ptr() if fused else None, dbc.data_ptr(),
        dA.data_ptr(), dDr.data_ptr(), dbr.data_ptr() if fused else None, dh0.data_ptr(),
        mid.data_ptr(), N, T, dI, dS, G, CHUNK, BWD_BLOCK, BWD_SUB, _DTYPE[x.dtype],
        int(fused and dt_bias.dtype == torch.bfloat16), build.stream_ptr(x))
    build.check(code, "mamba_scan backward")
    dbc = dbc.sum(0)
    return (dx, ddt, dbc[..., :dS].to(Bt.dtype), dbc[..., dS:].to(Ct.dtype),
            grad.group_sum(dA, A_log).to(A_log.dtype), grad.group_sum(dDr, D).to(D.dtype),
            dh0.to(h0.dtype),
            grad.group_sum(dbr, dt_bias).to(dt_bias.dtype) if fused else None, dz)
