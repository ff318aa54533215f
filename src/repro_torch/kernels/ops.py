"""Op entry points of the fused grouped cell and of decode attention.

Each takes the caller's layouts and hands views (no copies) to a kernel
wrapper. A CPU tensor goes to the kernel's plain version; a CUDA tensor
goes to the CUDA kernel, or the call raises. Under gradients the GEMM,
flash and the two ARMT memory wrappers run the same forward inside their
autograd Functions (``kernels/grad.py`` holds the backwards).

Every op takes the reference's ``config=`` (a ``dispatch.KernelConfig``,
as the autotuner passes its candidates) and ``use_kernel=`` (the per-call
override: ``False`` is the one way to the plain version on a CUDA tensor,
for the tests and the card checks). Without either, the kernel wrapper
resolves its config in ``kernels/dispatch.py``, keyed on the shapes it is
given (the flat layouts below: [G,R,K], [N,H,T,hd], [N,T,dI]).
"""
from __future__ import annotations

from repro_torch.kernels.armt_memory import armt_read, armt_update
from repro_torch.kernels.decode_attention import decode_attention as _decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.grouped_matmul import grouped_matmul, grouped_matmul_armt_update
from repro_torch.kernels.mamba_scan import mamba_scan


def _dispatch(config, use_kernel) -> dict:
    """The dispatch keywords a caller set: none by default, so a wrapper
    name that ``kernels/swap.py`` replaced with a plain version (which takes
    no such keywords) is called as the model calls it."""
    return {k: v for k, v in (("config", config), ("use_kernel", use_kernel)) if v is not None}


def grouped_gemm(x, w, bias=None, *, activation: str | None = None, widx=None, res=None,
                 out=None, config=None, use_kernel=None):
    """x: [G,R,K] or the grouped-block layout [G,B,T,K]; w: [G,K,N];
    bias: [G,N] or None -> [G,R,N] / [G,B,T,N]. widx: int32 [G] layer
    index into a stack w [Lw,K,N] (group i reads w[widx[i]]). res: shaped
    like the output, added before the cast. out: a contiguous [G,R,N]
    tensor the result is written into (x 3-D only)."""
    kw = _dispatch(config, use_kernel)
    if x.dim() == 4:
        if out is not None:
            raise ValueError("grouped_gemm(out=...) takes a 3-D x")
        G, B, T, K = x.shape
        y = grouped_matmul(x.reshape(G, B * T, K), w, bias, activation=activation,
                           widx=widx, res=None if res is None else res.reshape(G, B * T, -1),
                           **kw)
        return y.reshape(G, B, T, y.shape[-1])
    return grouped_matmul(x, w, bias, activation=activation, widx=widx, res=res, out=out,
                          **kw)


def grouped_gemm_armt_update(x, w, res, wk, wv, wb, A, z, bias=None, *,
                             M: int, nu: int = 3, widx=None, config=None, use_kernel=None):
    """The B == 1 cell's down projection with the ARMT update fused in.
    x: [G,R,K] or the cell layout [G,1,T,K]; res: [G,R,N] / [G,1,T,N];
    w: [G,K,N] (or a stack with the layer index widx) -> (y shaped like
    res, A', z'), y = res + x @ w (+ bias) and (A, z) updated from the last
    M rows of each group's y."""
    kw = dict(M=M, nu=nu, widx=widx, **_dispatch(config, use_kernel))
    if x.dim() == 4:
        G, B, T, K = x.shape
        if B != 1:
            raise ValueError(f"grouped_gemm_armt_update: batch {B} != 1")
        y, A2, z2 = grouped_matmul_armt_update(
            x.reshape(G, T, K), w, res.reshape(G, T, res.shape[-1]), wk, wv, wb,
            A, z, bias, **kw)
        return y.reshape(res.shape), A2, z2
    return grouped_matmul_armt_update(x, w, res, wk, wv, wb, A, z, bias, **kw)


def segment_attention(q, k, v, *, causal: bool = True, window: int = 0, config=None,
                      use_kernel=None):
    """q: [N,Hq,T,hd], k/v: [N,Hkv,S,hd]; or the grouped-block layout
    q: [G,B,T,Hq,hd], k/v: [G,B,S,Hkv,hd], passed to the kernel as strided
    [N,H,T,hd] views and returned as [G,B,T,Hq,hd]."""
    kw = dict(causal=causal, window=window, **_dispatch(config, use_kernel))
    if q.dim() == 5:
        G, B, T, Hq, hd = q.shape

        def flat(a):
            return a.reshape((G * B,) + a.shape[2:]).transpose(1, 2)
        out = flash_attention(flat(q), flat(k), flat(v), **kw)
        return out.transpose(1, 2).reshape(G, B, T, Hq, hd)
    return flash_attention(q, k, v, **kw)


def decode_attention(q, k, v, lengths, *, window: int = 0, config=None, use_kernel=None):
    """Single-token decode attention against the serve KV-cache layout.
    q: [B,Hq,hd]; k/v: [B,S,Hkv,hd]; lengths: int32 [B], the valid prefix
    of each row (its current token included) -> [B,Hq,hd]."""
    return _decode_attention(q, k, v, lengths, window=window,
                             **_dispatch(config, use_kernel))


def assoc_read(x, wq, A, z, *, nu: int = 3, config=None, use_kernel=None):
    """The ARMT memory read. x: [N,T,D]; wq: [D,dm] or [G,D,dm]; A:
    [N,P,Dv]; z: [N,P] -> [N,T,Dv] in x.dtype."""
    return armt_read(x, wq, A, z, nu=nu, **_dispatch(config, use_kernel))


def assoc_update(m, wk, wv, wb, A, z, *, nu: int = 3, config=None, use_kernel=None):
    """The ARMT delta-rule update from memory rows m: [N,M,D]; wk/wv/wb:
    [D,*] or [G,D,*]; A: [N,P,Dv]; z: [N,P] -> (A', z') in new buffers."""
    return armt_update(m, wk, wv, wb, A, z, nu=nu, **_dispatch(config, use_kernel))


def selective_scan_fused(x, dt, Bt, Ct, A_log, D, h0, *, dt_bias=None, z=None, config=None,
                         use_kernel=None):
    """The Mamba-1 scan with its D skip, and with ``dt_bias``/``z`` the
    mixer's dt softplus and output gate (see ``mamba_scan``). Plain layout:
    x/dt/z [B,T,dI], Bt/Ct [B,T,dS], A_log [dI,dS], D and dt_bias [dI], h0
    [B,dI,dS]. Grouped band layout: x/dt/z [G,B,T,dI], Bt/Ct [G,B,T,dS],
    A_log [G,dI,dS], D and dt_bias [G,dI], h0 [G,B,dI,dS], one launch over
    N = G*B rows. -> (y shaped like x: fp32, or x's dtype with z; hT fp32
    shaped like h0)."""
    kw = dict(dt_bias=dt_bias, **_dispatch(config, use_kernel))
    if x.dim() == 4:
        G, B = x.shape[:2]

        def flat(a):
            return a.reshape((G * B,) + a.shape[2:])
        y, hT = mamba_scan(flat(x), flat(dt), flat(Bt), flat(Ct), A_log, D, flat(h0),
                           z=None if z is None else flat(z), **kw)
        return y.reshape(x.shape), hT.reshape(h0.shape)
    return mamba_scan(x, dt, Bt, Ct, A_log, D, h0, z=z, **kw)


__all__ = ["grouped_gemm", "grouped_gemm_armt_update", "segment_attention",
           "decode_attention", "assoc_read", "assoc_update", "selective_scan_fused"]
