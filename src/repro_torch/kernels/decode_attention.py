"""Single-token decode attention against the serve KV cache.

Replaces the Pallas kernel ``decode_attention``
(repro/kernels/decode_attention.py:67): one query token per row, q
``[B,Hq,hd]``, against the valid prefix ``[0, len)`` of the cache k/v
``[B,S,Hkv,hd]`` (kv head = h // rep, scale hd^-1/2, keys below
``len - window`` masked when window > 0), fp32 online softmax. The kernel
reads q and the cache through their strides and stops each row's key loop
at its length. CUDA source: ``csrc/decode_attention.cu``; plain version:
``decode_attention_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import decode_attention_ref as decode_attention_plain

launches = 0   # kernel launches since the last reset

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_GROUP_WIDTH = 1024   # (Hq // Hkv) * hd: the outputs one block holds


def decode_attention(q, k, v, lengths, *, window: int = 0):
    """q: [B,Hq,hd]; k/v: [B,S,Hkv,hd], any strides with a contiguous last
    dim; lengths: [B] int32 in [1, S] (the current token included) ->
    [B,Hq,hd] in q.dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or Hq % Hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if hd > MAX_HEAD_DIM or (Hq // Hkv) * hd > MAX_GROUP_WIDTH:
        raise ValueError(f"decode_attention: hd {hd}, {Hq // Hkv} heads per kv head "
                         "unsupported")
    if q.dtype not in _DTYPE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if q.stride(2) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode_attention: head dim must be contiguous")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError(f"decode_attention: lengths {tuple(lengths.shape)} "
                         f"{lengths.dtype} must be contiguous int32 [B]")
    if not (q.device == k.device == v.device == lengths.device):
        raise ValueError("decode_attention: operands on different devices")
    if window < 0:
        raise ValueError(f"decode_attention: window {window} < 0")
    out = torch.empty(B, Hq, hd, dtype=q.dtype, device=q.device)
    if B * Hq == 0:
        return out
    launches += 1
    code = build.lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, S, hd, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
        int(window), float(hd ** -0.5), _DTYPE[q.dtype], build.stream_ptr(q))
    build.check(code, "decode_attention")
    return out
