"""Plain PyTorch versions of the port's kernels: the four of the diagonal
prefill, the fused down-projection + ARMT update of the B == 1 cell,
single-token decode attention, and the Mamba-1 selective scan.

Each is the same function as its CUDA kernel, written as framework ops: the
CPU path of every wrapper, and the oracle each kernel is held against on
the card. They port the reference oracles one to one (fp32 accumulation,
epilogues on the fp32 accumulator, A/z state in fp32).

A group's result does not depend on how many groups the call holds, as a
kernel's does not: a band of one layer, a stage's block of the band or a
pooled step gives each group the bits it has in the whole band. The ARMT
read and update with per-group weights therefore run group by group (a
batched product folds into another route, a matrix-vector one, at one
group, and a reduction's order follows the shape).
"""
from __future__ import annotations

import torch

from repro_torch.core.memory import dpfp

EPS = 1e-6
NEG_INF = -1e30


def grouped_matmul_ref(x, w, bias=None, *, activation: str | None = None, widx=None,
                       res=None, out=None):
    """x: [G,R,K] @ w: [G,K,N] (+ bias [G,N]) -> [G,R,N] in x.dtype; fp32
    accumulation, bias + silu / tanh-gelu applied to the fp32 accumulator,
    then res ([G,R,N]) added before the one cast. widx: int [G] layer
    index, group i taking w[widx[i]] (and its bias) of a stack w
    [Lw,K,N]. out: a [G,R,N] tensor the result is copied into (and
    returned)."""
    if widx is not None:
        w = w.index_select(0, widx)
        bias = None if bias is None else bias.index_select(0, widx)
    acc = torch.matmul(x.float(), w.float())
    if bias is not None:
        acc = acc + bias.float()[:, None, :]
    if activation == "silu":
        acc = acc * torch.sigmoid(acc)
    elif activation == "gelu":
        acc = torch.nn.functional.gelu(acc, approximate="tanh")
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    if res is not None:
        acc = acc + res.float()
    return acc.to(x.dtype) if out is None else out.copy_(acc)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [N,Hq,T,hd]; k/v: [N,Hkv,S,hd] -> [N,Hq,T,hd]; GQA kv head =
    h // rep, scale hd^-1/2, fp32 softmax."""
    T, hd = q.shape[2], q.shape[3]
    S = k.shape[2]
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.matmul(q, k.transpose(-1, -2)).float() * hd ** -0.5
    qpos = torch.arange(T, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones(T, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > (qpos - window)
        if not causal:
            mask &= kpos < (qpos + window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def decode_attention_ref(q, k, v, lengths, *, window: int = 0):
    """q: [B,Hq,hd]; k/v: [B,S,Hkv,hd] (the KV-cache layout); lengths: [B]
    (valid prefix, the current token included) -> [B,Hq,hd]. GQA kv head =
    h // rep, scale hd^-1/2, fp32 softmax over keys [len - window, len) (all
    of [0, len) when window == 0), P.V in fp32."""
    B, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    kh = k.transpose(1, 2).repeat_interleave(rep, dim=1)         # [B,Hq,S,hd]
    vh = v.transpose(1, 2).repeat_interleave(rep, dim=1)
    s = torch.einsum("bhd,bhsd->bhs", q, kh).float() * hd ** -0.5
    kpos = torch.arange(S, device=q.device)[None, None, :]
    lens = lengths.to(torch.int64)[:, None, None]
    mask = kpos < lens
    if window > 0:
        mask &= kpos > (lens - 1 - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p, vh.float()).to(q.dtype)


def _proj(x, w):
    """x: [N,T,D] @ w: [D,E] (shared) or [G,D,E] (per group, N = G*batch)."""
    if w.dim() == 2:
        return torch.matmul(x, w)
    G, N = w.shape[0], x.shape[0]
    out = torch.matmul(x.reshape((G, N // G) + x.shape[1:]), w[:, None])
    return out.reshape((N,) + out.shape[2:])


def _by_group(fn, G: int, rows, weights):
    """fn(*rows, *weights) over each of G groups alone: rows the tensors
    whose dim 0 is N = G * batch, weights the per-group [G, ...] ones (each
    group's a [1, ...] slice); the outputs concatenated on dim 0."""
    Bn = rows[0].shape[0] // G
    outs = [fn(*(t[g * Bn:(g + 1) * Bn] for t in rows), *(w[g:g + 1] for w in weights))
            for g in range(G)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def armt_read_ref(x, wq, A, z, *, nu: int = 3):
    """x: [N,T,D]; wq: [D,dm] or [G,D,dm]; A: [N,P,Dv]; z: [N,P] -> [N,T,Dv]."""
    if wq.dim() == 3 and wq.shape[0] > 1:
        return _by_group(lambda x, A, z, wq: armt_read_ref(x, wq, A, z, nu=nu),
                         wq.shape[0], (x, A, z), (wq,))
    pq = dpfp(_proj(x.float(), wq.float()), nu)
    num = torch.matmul(pq, A.float())
    den = torch.einsum("ntp,np->nt", pq, z.float()) + EPS
    return (num / den[..., None]).to(x.dtype)


def armt_update_ref(m, wk, wv, wb, A, z, *, nu: int = 3):
    """m: [N,M,D]; wk/wv/wb: [D,*] or [G,D,*]; A: [N,P,Dv]; z: [N,P] ->
    (A', z'), new tensors."""
    if wk.dim() == 3 and wk.shape[0] > 1:
        return _by_group(lambda m, A, z, wk, wv, wb: armt_update_ref(m, wk, wv, wb, A, z, nu=nu),
                         wk.shape[0], (m, A, z), (wk, wv, wb))
    m32 = m.float()
    k = _proj(m32, wk.float())
    v = _proj(m32, wv.float())
    beta = torch.sigmoid(_proj(m32, wb.float()))[..., 0]
    pk = dpfp(k, nu)
    zk = torch.einsum("nmp,np->nm", pk, z.float())
    vbar = torch.matmul(pk, A.float()) / (zk + EPS)[..., None]
    gamma = 1.0 - zk / ((pk * pk).sum(-1) + EPS)
    A_new = A.float() + torch.matmul(pk.transpose(1, 2),
                                     beta[..., None] * (v - vbar))
    z_new = z.float() + torch.einsum("nm,nmp->np", gamma, pk)
    return A_new.to(A.dtype), z_new.to(z.dtype)


def grouped_matmul_armt_update_ref(x, w, res, wk, wv, wb, A, z, bias=None, *,
                                   M: int, nu: int = 3, widx=None):
    """The fused down projection + ARMT update of the B == 1 cell. x:
    [G,R,K]; w: [G,K,N] (or [Lw,K,N] with the layer index widx); res:
    [G,R,N] -> (y, A', z'): y = res + x @ w (+ bias), accumulated and summed
    in fp32 and cast once, then (A, z) delta-updated from the last M rows
    of each group's y, read after the cast."""
    y = (grouped_matmul_ref(x.float(), w.float(), bias, widx=widx)
         + res.float()).to(res.dtype)
    A2, z2 = armt_update_ref(y[:, -M:, :], wk, wv, wb, A, z, nu=nu)
    return y, A2, z2


def mamba_scan_ref(x, dt, Bt, Ct, A_log, D, h0, *, dt_bias=None, z=None):
    """Token-sequential Mamba-1 selective scan in fp32, with the mixer's dt
    prologue and gate epilogue when asked.

    x/dt: [N,T,dI]; Bt/Ct: [N,T,dS]; h0: [N,dI,dS]; A_log: [dI,dS] and D:
    [dI] shared by every row, or [G,dI,dS] and [G,dI] per group (row n
    takes group n // (N // G)) -> (y [N,T,dI], hT [N,dI,dS] fp32):

        h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,   A = -exp(A_log)
        y_t = h_t . C_t + D * x_t

    With ``dt_bias`` (shaped like D) and ``z`` ([N,T,dI]), both or neither,
    dt is the raw dt_proj output, the scan uses ``softplus(dt + dt_bias)``
    in fp32 and y comes back as ``y.to(z.dtype) * silu(z)``; otherwise y is
    fp32. Eager PyTorch ops in the mixer's order, so each rounds where the
    mixer's did.
    """
    if (dt_bias is None) != (z is None):
        raise ValueError("mamba_scan: dt_bias and z go together (the fused form) or not at all")
    N, T, dI = x.shape
    A = -torch.exp(A_log.float())
    Dv = D.float()
    if dt_bias is not None:
        bias = dt_bias.float()
        bias = bias.repeat_interleave(N // bias.shape[0], 0)[:, None] if bias.dim() == 2 \
            else bias
        dt = torch.nn.functional.softplus(dt.float() + bias)
    if A.dim() == 3:
        rep = N // A.shape[0]
        A, Dv = A.repeat_interleave(rep, 0), Dv.repeat_interleave(rep, 0)
    else:
        A, Dv = A[None], Dv[None]
    x32, dt32, B32, C32 = x.float(), dt.float(), Bt.float(), Ct.float()
    h = h0.float()
    ys = []
    for t in range(T):
        x_t, dt_t = x32[:, t], dt32[:, t]
        h = torch.exp(dt_t[..., None] * A) * h + (dt_t * x_t)[..., None] * B32[:, t, None, :]
        ys.append(torch.einsum("nis,ns->ni", h, C32[:, t]) + Dv * x_t)
    y = torch.stack(ys, 1) if ys else x32.new_zeros(N, 0, dI)
    if z is not None:
        y = y.to(z.dtype) * torch.nn.functional.silu(z)
    return y, h
