"""Causal GQA flash attention over a group of segments.

Replaces the Pallas kernel ``flash_attention`` (repro/kernels/flash_attention.py:89).
``flash_attention`` computes online-softmax attention of q ``[N,Hq,T,hd]``
against k/v ``[N,Hkv,S,hd]`` (kv head = h // rep, scale hd^-1/2, causal
and/or sliding window). The kernel reads each operand through its strides,
so the grouped cell's ``[G,B,T,H,hd]`` activations go in without a
transpose copy; the output is a ``[N,Hq,T,hd]`` view of a contiguous
``[N,T,Hq,hd]`` buffer. CUDA source: ``csrc/flash_attention.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

launches = 0   # kernel launches since the last reset

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [N,Hq,T,hd]; k/v: [N,Hkv,S,hd], any strides with a contiguous
    last dim -> [N,Hq,T,hd] in q.dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
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
    global launches
    launches += 1
    code = build.lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        N, Hq, Hkv, T, S, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(causal), int(window), float(hd ** -0.5), _DTYPE[q.dtype],
        build.stream_ptr(q))
    build.check(code, "flash_attention")
    return out.transpose(1, 2)
