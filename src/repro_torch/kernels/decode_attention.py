"""Single-token decode attention against the serve KV cache.

Replaces the Pallas kernel ``decode_attention``
(repro/kernels/decode_attention.py:67): one query token per row, q
``[B,Hq,hd]``, against the valid prefix ``[0, len)`` of the cache k/v
``[B,S,Hkv,hd]`` (kv head = h // rep, scale hd^-1/2, keys below
``len - window`` masked when window > 0), fp32 softmax. CUDA source:
``csrc/decode_attention.cu``; plain version: ``decode_attention_plain``.

On the card the keys are split into fixed chunks (``split_plan``, chosen
from the cache length S alone, so the host never reads ``lengths`` and a
row rounds the same whatever rows are batched with it), and the q heads of
a kv head into groups whose outputs one block holds (``head_groups``: one
group but at chatglm3-6b's 16 heads of 128 dims, two of 8; a head's sums
do not depend on its group). One call is two kernel launches: the partials
(m, l, o) of every (chunk, kv head and head group, row), read through q's
and the cache's strides and skipping keys outside each row's window and
length, then their combine. It counts as one ``decode_attention`` launch.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grad import needs_grad
from repro_torch.kernels.ref import decode_attention_ref as decode_attention_plain

launches = 0   # kernel launches since the last reset
build.count_launches(sys.modules[__name__], "launches")

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_GROUP_WIDTH = 1024   # heads a block * hd: the outputs one block holds
TILE = 64                # keys a block scores at a time; a chunk is a multiple
MAX_SPLITS = 64


def head_groups(rep: int, hd: int) -> tuple[int, int]:
    """(heads a block, groups a kv head) for rep q heads of hd dims per kv
    head: the fewest groups of at most MAX_GROUP_WIDTH // hd heads, sized
    as evenly as they go (the last may hold fewer)."""
    n = -(-rep * hd // MAX_GROUP_WIDTH)
    per = -(-rep // n)
    return per, -(-rep // per)


def split_plan(S: int) -> tuple[int, int]:
    """(chunk, n_splits) for a cache of S rows: chunks of 64 keys, or the
    smallest multiple of 64 that keeps the count at most MAX_SPLITS; split c
    covers keys [c * chunk, min(S, (c + 1) * chunk))."""
    tiles = -(-S // TILE)
    chunk = TILE * max(1, -(-tiles // MAX_SPLITS))
    return chunk, -(-S // chunk)


def decode_attention(q, k, v, lengths, *, window: int = 0):
    """q: [B,Hq,hd]; k/v: [B,S,Hkv,hd], any strides with a contiguous last
    dim; lengths: [B] int32 in [1, S] (the current token included) ->
    [B,Hq,hd] in q.dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises. Forward-only (serving): it has no autograd Function, so an
    operand that requires a gradient, with gradients on, raises rather
    than have the kernel drop it."""
    global launches
    if needs_grad(q, k, v):
        raise ValueError("decode_attention is forward-only (serving): it has no backward")
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
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {hd} > {MAX_HEAD_DIM}")
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
    if S < 1:
        raise ValueError("decode_attention: empty cache")
    out = torch.empty(B, Hq, hd, dtype=q.dtype, device=q.device)
    if B * Hq == 0:
        return out
    chunk, n_splits = split_plan(S)
    part_o = torch.empty(B, Hq, n_splits, hd, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(B, Hq, n_splits, 2, dtype=torch.float32, device=q.device)
    code = build.lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_o.data_ptr(), part_ml.data_ptr(), B, Hq, Hkv, S, hd, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1), v.stride(2),
        int(window), float(hd ** -0.5), chunk, n_splits, head_groups(Hq // Hkv, hd)[0],
        _DTYPE[q.dtype], build.stream_ptr(q))
    build.check(code, "decode_attention")
    launches += 1
    return out
