"""Causal GQA flash attention over a group of segments.

Replaces the Pallas kernel ``flash_attention`` (repro/kernels/flash_attention.py:89).
``flash_attention`` computes online-softmax attention of q ``[N,Hq,T,hd]``
against k/v ``[N,Hkv,S,hd]`` (kv head = h // rep, scale hd^-1/2, causal
and/or sliding window). The kernel reads each operand through its strides,
so the grouped cell's ``[G,B,T,H,hd]`` activations go in without a
transpose copy; the output is a ``[N,Hq,T,hd]`` view of a contiguous
``[N,T,Hq,hd]`` buffer. CUDA source: ``csrc/flash_attention.cu``.

Every launch takes one of two routes, which ``route()`` picks and the module
counts: the TMA + wgmma kernel for bf16 operands with head dim 64, 80, 112
or 128 whose bases and strides the TMA can describe (hd 80 and 112 on hd
128's tile layout, the columns past the head dim zero-filled on chip: no
padded copy), the fp32 SIMT kernel for the rest.

Under gradients the call runs through ``FlashAttentionFn``: the kernel
forward, and a backward in PyTorch ops (``kernels/grad.py``) that
recomputes the scores in fp32 a few rows at a time.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.kernels import build, grad
from repro_torch.kernels.grad import needs_grad
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

launches = 0        # kernel launches since the last reset
tc_launches = 0     # of those, on the TMA + wgmma kernel
simt_launches = 0   # of those, on flash_simt
build.count_launches(sys.modules[__name__], "launches", "tc_launches", "simt_launches")

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
TC_HEAD_DIMS = (64, 80, 112, 128)


def _strides(x):
    """x's (n, h, t) strides for x [N,H,T,hd], those of a size-1 dim
    replaced by the stride a contiguous tensor would have there: PyTorch
    leaves a size-1 dim's stride arbitrary, and a TMA tensor map needs a
    real one."""
    N, H, T, hd = x.shape
    st = x.stride(2) if T > 1 else hd
    sh = x.stride(1) if H > 1 else T * st
    return (x.stride(0) if N > 1 else H * sh), sh, st


def route(q, k, v) -> str:
    """The kernel a launch of these operands takes: "wgmma" (the TMA +
    wgmma kernel: bf16, head dim 64, 80, 112 or 128, T and S > 0, 16-byte-aligned
    bases and every (n, h, t) stride a positive multiple of 8 elements, so
    the TMA reads whole 16-byte pieces) or "simt" (any dtype and head dim)."""
    hd = q.shape[3]
    strides = _strides(q) + _strides(k) + _strides(v)
    if (q.dtype == torch.bfloat16 and hd in TC_HEAD_DIMS and q.shape[2] > 0
            and k.shape[2] > 0 and all(s > 0 and s % 8 == 0 for s in strides)
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v))):
        return "wgmma"
    return "simt"


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [N,Hq,T,hd]; k/v: [N,Hkv,S,hd], any strides with a contiguous
    last dim -> [N,Hq,T,hd] in q.dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises. With gradients on and an operand that requires one, the call
    goes through ``FlashAttentionFn`` (its backward in ``kernels/grad.py``)."""
    if needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return _flash_attention(q, k, v, causal=causal, window=window)


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` under autograd: the kernel (on the CPU its plain
    version) forward; backward ``grad.flash_attention_bwd``, which
    recomputes the scores from q, k and v (the kernel keeps no softmax
    statistics) and reads the output."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = _flash_attention(q, k, v, causal=causal, window=window)
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = grad.flash_attention_bwd(q, k, v, out, do, causal=ctx.causal,
                                              window=ctx.window)
        return dq, dk, dv, None, None


def _flash_attention(q, k, v, *, causal: bool, window: int):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    N, Hq, T, hd = q.shape
    _, Hkv, S, _ = k.shape
    if k.shape[0] != N or k.shape[3] != hd or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} > {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: head dim must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: operands on different devices")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    out = torch.empty(N, T, Hq, hd, dtype=q.dtype, device=q.device)
    if N * Hq * T == 0:
        return out.transpose(1, 2)
    global launches, tc_launches, simt_launches
    tc = route(q, k, v) == "wgmma"
    code = build.lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        N, Hq, Hkv, T, S, hd, *_strides(q), *_strides(k), *_strides(v),
        int(causal), int(window), float(hd ** -0.5), _DTYPE[q.dtype], int(tc),
        build.stream_ptr(q))
    build.check(code, "flash_attention")
    launches += 1
    if tc:
        tc_launches += 1
    else:
        simt_launches += 1
    return out.transpose(1, 2)
