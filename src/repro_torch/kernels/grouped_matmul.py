"""Grouped matmul with a fused bias + activation epilogue.

Replaces the Pallas kernel ``grouped_matmul`` (repro/kernels/grouped_matmul.py:198).
``grouped_matmul`` computes ``x[G,R,K] @ w[G,K,N] (+ bias[G,N])`` with silu
or tanh-gelu applied to the fp32 accumulator; the CUDA kernel is in
``csrc/grouped_matmul.cu``, its plain version is ``grouped_matmul_plain``.

``project_f32`` runs the same kernel with an fp32 epilogue for the ARMT
memory kernels' projections (their launches count as theirs, not here).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import grouped_matmul_ref as grouped_matmul_plain

launches = 0   # kernel launches since the last reset

_ACT = {None: 0, "silu": 1, "gelu": 2}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def launch(x, w, bias, out, *, wbatch: int = 1, activation=None):
    """out[i] = act(x[i] @ w[i // wbatch] + bias[i // wbatch]) on the card.
    x: [G,R,K] with a contiguous last dim; w: [G/wbatch,K,N] contiguous;
    out: [G,R,N] contiguous, in x.dtype or float32. Returns whether a kernel
    was launched (nothing is launched for an empty output)."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"grouped_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be 3-D")
    G, R, K = x.shape
    if G % wbatch or w.shape[:2] != (G // wbatch, K):
        raise ValueError(f"grouped_matmul: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    N = w.shape[2]
    if x.dtype not in _DTYPE or w.dtype != x.dtype:
        raise ValueError(f"grouped_matmul: dtypes {x.dtype}/{w.dtype}")
    if x.stride(2) != 1:
        raise ValueError("grouped_matmul: x's last dim must be contiguous")
    if not w.is_contiguous():
        raise ValueError("grouped_matmul: w must be contiguous")
    if bias is not None and (bias.shape != (G // wbatch, N) or bias.dtype != x.dtype
                             or not bias.is_contiguous()):
        raise ValueError(f"grouped_matmul: bias {tuple(bias.shape)} {bias.dtype}")
    if out.shape != (G, R, N) or not out.is_contiguous() or \
            out.dtype not in (x.dtype, torch.float32):
        raise ValueError(f"grouped_matmul: out {tuple(out.shape)} {out.dtype}")
    if any(t is not None and t.device != x.device for t in (w, bias, out)):
        raise ValueError("grouped_matmul: operands on different devices")
    if G * R * N == 0:
        return False
    code = build.lib().gmm_launch(
        x.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), G, R, K, N, x.stride(0), x.stride(1), wbatch,
        _DTYPE[x.dtype], int(out.dtype == torch.float32), _ACT[activation],
        build.stream_ptr(x))
    build.check(code, "grouped_matmul")
    return True


def grouped_matmul(x, w, bias=None, *, activation: str | None = None):
    """x: [G,R,K] (rows may be strided; the last dim contiguous), w:
    [G,K,N] contiguous, bias: [G,N] or None -> [G,R,N] in x.dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises."""
    global launches
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, bias, activation=activation)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul: unsupported device {x.device}")
    if activation not in _ACT:
        raise ValueError(f"grouped_matmul: unknown activation {activation!r}")
    out = torch.empty(x.shape[0], x.shape[1], w.shape[-1], dtype=x.dtype,
                      device=x.device)
    if launch(x, w, bias, out, activation=activation):
        launches += 1
    return out


def project_f32(x, w, batch: int):
    """fp32 ``x[n] @ w[n // batch]`` on the card for the ARMT kernels. x:
    [N,R,D]; w: [D,E] (shared) or [G,D,E] with N = G*batch -> [N,R,E] fp32.
    bf16 x bf16 products are exact in fp32, so this is the reference's fp32
    projection up to summation order."""
    if w.dim() == 2:
        w, batch = w[None], x.shape[0]
    out = torch.empty(x.shape[0], x.shape[1], w.shape[-1], dtype=torch.float32,
                      device=x.device)
    launch(x, w, None, out, wbatch=batch)
    return out
