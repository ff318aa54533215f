"""Op entry points of the fused grouped cell.

Each takes the cell's layouts and hands views (no copies) to a kernel
wrapper. A CPU tensor goes to the kernel's plain version; a CUDA tensor
goes to the CUDA kernel, or the call raises. There is no other dispatch.
"""
from __future__ import annotations

from repro_torch.kernels.armt_memory import armt_read as assoc_read
from repro_torch.kernels.armt_memory import armt_update as assoc_update
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.grouped_matmul import grouped_matmul


def grouped_gemm(x, w, bias=None, *, activation: str | None = None):
    """x: [G,R,K] or the grouped-block layout [G,B,T,K]; w: [G,K,N];
    bias: [G,N] or None -> [G,R,N] / [G,B,T,N]."""
    if x.dim() == 4:
        G, B, T, K = x.shape
        out = grouped_matmul(x.reshape(G, B * T, K), w, bias,
                             activation=activation)
        return out.reshape(G, B, T, out.shape[-1])
    return grouped_matmul(x, w, bias, activation=activation)


def segment_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [N,Hq,T,hd], k/v: [N,Hkv,S,hd]; or the grouped-block layout
    q: [G,B,T,Hq,hd], k/v: [G,B,S,Hkv,hd], passed to the kernel as strided
    [N,H,T,hd] views and returned as [G,B,T,Hq,hd]."""
    if q.dim() == 5:
        G, B, T, Hq, hd = q.shape

        def flat(a):
            return a.reshape((G * B,) + a.shape[2:]).transpose(1, 2)
        out = flash_attention(flat(q), flat(k), flat(v), causal=causal,
                              window=window)
        return out.transpose(1, 2).reshape(G, B, T, Hq, hd)
    return flash_attention(q, k, v, causal=causal, window=window)


__all__ = ["grouped_gemm", "segment_attention", "assoc_read", "assoc_update"]
