"""Op entry points of the fused grouped cell and of decode attention.

Each takes the caller's layouts and hands views (no copies) to a kernel
wrapper. A CPU tensor goes to the kernel's plain version; a CUDA tensor
goes to the CUDA kernel, or the call raises. Under gradients the GEMM,
flash and the two ARMT memory wrappers run the same forward inside their
autograd Functions (``kernels/grad.py`` holds the backwards).
"""
from __future__ import annotations

from repro_torch.kernels.armt_memory import armt_read as assoc_read
from repro_torch.kernels.armt_memory import armt_update as assoc_update
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.grouped_matmul import grouped_matmul, grouped_matmul_armt_update
from repro_torch.kernels.mamba_scan import mamba_scan


def grouped_gemm(x, w, bias=None, *, activation: str | None = None, widx=None, res=None,
                 out=None):
    """x: [G,R,K] or the grouped-block layout [G,B,T,K]; w: [G,K,N];
    bias: [G,N] or None -> [G,R,N] / [G,B,T,N]. widx: int32 [G] layer
    index into a stack w [Lw,K,N] (group i reads w[widx[i]]). res: shaped
    like the output, added before the cast. out: a contiguous [G,R,N]
    tensor the result is written into (x 3-D only)."""
    if x.dim() == 4:
        if out is not None:
            raise ValueError("grouped_gemm(out=...) takes a 3-D x")
        G, B, T, K = x.shape
        y = grouped_matmul(x.reshape(G, B * T, K), w, bias, activation=activation,
                           widx=widx, res=None if res is None else res.reshape(G, B * T, -1))
        return y.reshape(G, B, T, y.shape[-1])
    return grouped_matmul(x, w, bias, activation=activation, widx=widx, res=res, out=out)


def grouped_gemm_armt_update(x, w, res, wk, wv, wb, A, z, bias=None, *,
                             M: int, nu: int = 3, widx=None):
    """The B == 1 cell's down projection with the ARMT update fused in.
    x: [G,R,K] or the cell layout [G,1,T,K]; res: [G,R,N] / [G,1,T,N];
    w: [G,K,N] (or a stack with the layer index widx) -> (y shaped like
    res, A', z'), y = res + x @ w (+ bias) and (A, z) updated from the last
    M rows of each group's y."""
    if x.dim() == 4:
        G, B, T, K = x.shape
        if B != 1:
            raise ValueError(f"grouped_gemm_armt_update: batch {B} != 1")
        y, A2, z2 = grouped_matmul_armt_update(
            x.reshape(G, T, K), w, res.reshape(G, T, res.shape[-1]), wk, wv, wb,
            A, z, bias, M=M, nu=nu, widx=widx)
        return y.reshape(res.shape), A2, z2
    return grouped_matmul_armt_update(x, w, res, wk, wv, wb, A, z, bias, M=M, nu=nu,
                                      widx=widx)


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


def selective_scan_fused(x, dt, Bt, Ct, A_log, D, h0, *, dt_bias=None, z=None):
    """The Mamba-1 scan with its D skip, and with ``dt_bias``/``z`` the
    mixer's dt softplus and output gate (see ``mamba_scan``). Plain layout:
    x/dt/z [B,T,dI], Bt/Ct [B,T,dS], A_log [dI,dS], D and dt_bias [dI], h0
    [B,dI,dS]. Grouped band layout: x/dt/z [G,B,T,dI], Bt/Ct [G,B,T,dS],
    A_log [G,dI,dS], D and dt_bias [G,dI], h0 [G,B,dI,dS], one launch over
    N = G*B rows. -> (y shaped like x: fp32, or x's dtype with z; hT fp32
    shaped like h0)."""
    if x.dim() == 4:
        G, B = x.shape[:2]

        def flat(a):
            return a.reshape((G * B,) + a.shape[2:])
        y, hT = mamba_scan(flat(x), flat(dt), flat(Bt), flat(Ct), A_log, D, flat(h0),
                           dt_bias=dt_bias, z=None if z is None else flat(z))
        return y.reshape(x.shape), hT.reshape(h0.shape)
    return mamba_scan(x, dt, Bt, Ct, A_log, D, h0, dt_bias=dt_bias, z=z)


__all__ = ["grouped_gemm", "grouped_gemm_armt_update", "segment_attention",
           "decode_attention", "assoc_read", "assoc_update", "selective_scan_fused"]
