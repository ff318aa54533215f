"""Backward formulas of the kernels on the training path, in PyTorch ops:
the grouped matmul, flash attention, armt_read and armt_update, and the
plain version of ``mamba_scan``'s backward kernel.

The reference has no backward kernel: none of its Pallas kernels has a
``custom_vjp``, and its gradient is XLA's gradient of the plain functions
of ``kernels/ref.py``. Each kernel's ``torch.autograd.Function`` (in its
own module) runs the kernel forward, and one of these functions backward,
the same code on the CPU and on the card. The products are batched
matmuls; the elementwise work is in fp32. ``mamba_scan``'s Function is the
exception: on the card its backward is a kernel of its own
(``csrc/mamba_scan_bwd.cu``), and ``mamba_scan_bwd_plain`` is that kernel's
plain version, the CPU's backward and its oracle.

``needs_grad`` decides which form a wrapper takes: the autograd Function
when gradients are on and an operand requires one, else the forward
alone (serving is unchanged).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.ref import EPS, NEG_INF

GELU_C = math.sqrt(2.0 / math.pi)
# flash's backward recomputes the fp32 scores a few rows n at a time, each
# [n, Hq, T, S] tensor at most this many bytes (about four are live)
FLASH_BWD_BYTES = 1 << 28


def needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# grouped matmul: y = act(x @ w + b) (+ res)
# ---------------------------------------------------------------------------

def act_grad(pre: torch.Tensor, activation) -> torch.Tensor:
    """d act / d pre at the fp32 pre-activation: silu and tanh-gelu."""
    if activation == "silu":
        s = torch.sigmoid(pre)
        return s * (1 + pre * (1 - s))
    if activation == "gelu":
        inner = GELU_C * (pre + 0.044715 * pre ** 3)
        t = torch.tanh(inner)
        return 0.5 * (1 + t) + 0.5 * pre * (1 - t * t) * GELU_C * (1 + 3 * 0.044715 * pre * pre)
    raise ValueError(f"unknown activation {activation!r}")


def grouped_matmul_bwd(x, w, bias, dy, pre, activation, need=(True, True, True)):
    """Gradients of ``act(x @ w + bias)`` to (x, w, bias) given dy [G,R,N]
    and the fp32 pre-activation ``pre`` (None without an activation):
    ``dz = dy * act'(pre)`` in fp32, ``dx = dz @ w^T`` and ``dw = x^T @
    dz`` per group in x's dtype (fp32 accumulation), ``db = sum dz`` in
    fp32 cast to the bias dtype. need: which of the three to compute."""
    if activation is None:
        dz32 = dy.float() if need[2] else None
        dz = dy.to(x.dtype)
    else:
        dz32 = dy.float() * act_grad(pre, activation)
        dz = dz32.to(x.dtype)
    dx = torch.matmul(dz, w.transpose(1, 2)) if need[0] else None
    dw = torch.matmul(x.transpose(1, 2), dz) if need[1] else None
    db = dz32.sum(1).to(bias.dtype) if need[2] and bias is not None else None
    return dx, dw, db


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def attention_mask(T: int, S: int, causal: bool, window: int, device) -> torch.Tensor:
    """[T, S] bool, the plain version's mask (``flash_attention_ref``)."""
    qpos = torch.arange(T, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    mask = torch.ones(T, S, dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > (qpos - window)
        if not causal:
            mask &= kpos < (qpos + window)
    return mask


def flash_attention_bwd(q, k, v, o, do, *, causal: bool, window: int):
    """Gradients of softmax attention to (q [N,Hq,T,hd], k, v [N,Hkv,S,hd])
    given the output o and its gradient do [N,Hq,T,hd]. Recomputes the fp32
    scores S = q k^T scale (the mask, GQA kv head h // rep) and P =
    softmax(S) a few rows n at a time, then dV = sum_group P^T dO, dP = dO
    V^T, dS = P (dP - rowsum(dO o)), dQ = dS K scale, dK = sum_group dS^T Q
    scale; returned in the operands' dtypes."""
    N, Hq, T, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = hd ** -0.5
    mask = attention_mask(T, S, causal, window, q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    step = max(1, FLASH_BWD_BYTES // max(1, Hq * T * S * 4))
    for n0 in range(0, N, step):
        sl = slice(n0, min(N, n0 + step))
        n = sl.stop - sl.start

        def heads(a):   # [n, Hq, T, hd] -> [n, Hkv, rep, T, hd] fp32
            return a[sl].float().reshape(n, Hkv, rep, T, hd)
        qc, oc, doc = heads(q), heads(o), heads(do)
        kc, vc = k[sl].float()[:, :, None], v[sl].float()[:, :, None]
        s = torch.matmul(qc, kc.transpose(-1, -2)) * scale
        p = torch.softmax(torch.where(mask, s, torch.full_like(s, NEG_INF)), dim=-1)
        del s
        dv[sl] = torch.matmul(p.transpose(-1, -2), doc).sum(2).to(dv.dtype)
        dp = torch.matmul(doc, vc.transpose(-1, -2))
        ds = p * (dp - (doc * oc).sum(-1, keepdim=True))
        del p, dp
        dq[sl] = (torch.matmul(ds, kc) * scale).reshape(n, Hq, T, hd).to(dq.dtype)
        dk[sl] = (torch.matmul(ds.transpose(-1, -2), qc).sum(2) * scale).to(dk.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# ARMT memory: the DPFP feature map and the per-group projections
# ---------------------------------------------------------------------------

def dpfp_fwd(x: torch.Tensor, nu: int):
    """(phi(x) [..., 2 nu d], r = [relu(x), relu(-x)] [..., 2d])."""
    r = torch.cat([torch.relu(x), torch.relu(-x)], dim=-1)
    return torch.cat([r * torch.roll(r, shifts=j, dims=-1) for j in range(1, nu + 1)],
                     dim=-1), r


def dpfp_bwd(x: torch.Tensor, r: torch.Tensor, dphi: torch.Tensor, nu: int) -> torch.Tensor:
    """d phi(x) -> d x. phi's block j is r * roll(r, j), so r's gradient
    gets dphi_j * roll(r, j) and roll(dphi_j * r, -j); relu's gradient is
    0 at 0 on both sides (as the reference's)."""
    d2 = r.shape[-1]
    dr = torch.zeros_like(r)
    for j in range(1, nu + 1):
        dj = dphi[..., (j - 1) * d2:j * d2]
        dr = dr + dj * torch.roll(r, shifts=j, dims=-1) + torch.roll(dj * r, shifts=-j, dims=-1)
    d = x.shape[-1]
    return dr[..., :d] * (x > 0) - dr[..., d:] * (x < 0)


def _per_group(a, G: int):
    """[N, ...] -> [G, N // G, ...]."""
    return a.reshape((G, a.shape[0] // G) + a.shape[1:])


def proj(x, w):
    """fp32 x [N,T,D] @ w [D,E] (shared) or [G,D,E] (row n takes group n //
    (N // G)) -> [N,T,E]; the plain version's ``_proj``."""
    if w.dim() == 2:
        return torch.matmul(x, w)
    out = torch.matmul(_per_group(x, w.shape[0]), w[:, None])
    return out.reshape((x.shape[0],) + out.shape[2:])


def proj_bwd(x, w, g):
    """Gradients of ``proj(x, w)`` given g [N,T,E] -> (dx [N,T,D], dw shaped
    like w), fp32."""
    if w.dim() == 2:
        return torch.matmul(g, w.t()), torch.einsum("ntd,nte->de", x, g)
    G = w.shape[0]
    dx = torch.matmul(_per_group(g, G), w.transpose(1, 2)[:, None]).reshape(x.shape)
    xg, gg = _per_group(x, G), _per_group(g, G)
    dw = torch.matmul(xg.reshape(G, -1, x.shape[-1]).transpose(1, 2),
                      gg.reshape(G, -1, g.shape[-1]))
    return dx, dw


def armt_read_bwd(x, wq, A, z, g, *, nu: int):
    """Gradients of the read ``num / den`` (num = phi(q) A, den = phi(q) . z
    + eps, q = x wq, all fp32) to (x, wq, A, z) given g [N,T,Dv]."""
    x32, A32, z32 = x.float(), A.float(), z.float()
    q = proj(x32, wq.float())
    pq, r = dpfp_fwd(q, nu)
    num = torch.matmul(pq, A32)
    den = torch.einsum("ntp,np->nt", pq, z32) + EPS
    g = g.float()
    d_num = g / den[..., None]
    d_den = -(g * num).sum(-1) / (den * den)
    dA = torch.matmul(pq.transpose(1, 2), d_num)
    dz = torch.einsum("nt,ntp->np", d_den, pq)
    d_pq = torch.matmul(d_num, A32.transpose(1, 2)) + d_den[..., None] * z32[:, None, :]
    dx, dwq = proj_bwd(x32, wq.float(), dpfp_bwd(q, r, d_pq, nu))
    return dx.to(x.dtype), dwq.to(wq.dtype), dA.to(A.dtype), dz.to(z.dtype)


def armt_update_bwd(m, wk, wv, wb, A, z, gA, gz, *, nu: int):
    """Gradients of the delta-rule update to (m, wk, wv, wb, A, z) given
    those of A' = A + phi(k)^T (beta (v - vbar)) and z' = z + gamma phi(k)
    (gA [N,P,Dv], gz [N,P]); vbar = phi(k) A / (phi(k) . z + eps) and gamma
    = 1 - phi(k) . z / (|phi(k)|^2 + eps) depend on A and z. All fp32."""
    m32, A32, z32 = m.float(), A.float(), z.float()
    wk32, wv32, wb32 = wk.float(), wv.float(), wb.float()
    gA, gz = gA.float(), gz.float()
    k = proj(m32, wk32)
    v = proj(m32, wv32)
    beta = torch.sigmoid(proj(m32, wb32))[..., 0]
    pk, r = dpfp_fwd(k, nu)
    zk = torch.einsum("nmp,np->nm", pk, z32)
    den = zk + EPS
    vbar = torch.matmul(pk, A32) / den[..., None]
    nn = (pk * pk).sum(-1) + EPS
    gamma = 1.0 - zk / nn
    u = v - vbar
    # A' = A + pk^T (beta u)
    d_pk = torch.matmul(beta[..., None] * u, gA.transpose(1, 2))
    d_bu = torch.matmul(pk, gA)
    d_beta = (d_bu * u).sum(-1)
    d_v = d_bu * beta[..., None]
    d_vbar = -d_v
    # vbar = (pk A) / den
    d_num = d_vbar / den[..., None]
    d_zk = -(d_vbar * vbar).sum(-1) / den
    dA = gA + torch.matmul(pk.transpose(1, 2), d_num)
    d_pk = d_pk + torch.matmul(d_num, A32.transpose(1, 2))
    # z' = z + gamma pk, gamma = 1 - zk / nn
    d_gamma = torch.einsum("nmp,np->nm", pk, gz)
    d_pk = d_pk + gamma[..., None] * gz[:, None, :]
    d_zk = d_zk - d_gamma / nn
    d_pk = d_pk + 2 * pk * (d_gamma * zk / (nn * nn))[..., None]
    # zk = pk . z
    d_pk = d_pk + d_zk[..., None] * z32[:, None, :]
    dz = gz + torch.einsum("nm,nmp->np", d_zk, pk)
    d_logit = (d_beta * beta * (1 - beta))[..., None]
    dm_k, dwk = proj_bwd(m32, wk32, dpfp_bwd(k, r, d_pk, nu))
    dm_v, dwv = proj_bwd(m32, wv32, d_v)
    dm_b, dwb = proj_bwd(m32, wb32, d_logit)
    return ((dm_k + dm_v + dm_b).to(m.dtype), dwk.to(wk.dtype), dwv.to(wv.dtype),
            dwb.to(wb.dtype), dA.to(A.dtype), dz.to(z.dtype))


# ---------------------------------------------------------------------------
# mamba_scan: the selective scan, with the fused dt prologue and gate
# ---------------------------------------------------------------------------

def _rows(v, N: int, shared_dims: int):
    """v shared (``shared_dims`` dims) or per group (one more) -> per row,
    fp32."""
    v = v.float()
    if v.dim() == shared_dims:
        return v[None].expand((N,) + tuple(v.shape))
    return v.repeat_interleave(N // v.shape[0], 0)


def group_sum(g, like):
    """A per-row gradient [N, ...] summed over the rows of each group ->
    shaped like ``like`` (shared: over every row)."""
    if like.dim() == g.dim() - 1:
        return g.sum(0)
    return g.reshape((like.shape[0], -1) + tuple(g.shape[1:])).sum(1)


def mamba_scan_bwd_plain(x, dt, Bt, Ct, A_log, D, h0, dy, dhT, *, dt_bias=None, z=None):
    """Gradients of ``mamba_scan`` (the TPU form, or the fused one with
    ``dt_bias`` and ``z``) given dy [N,T,dI] and dhT [N,dI,dS] (None: zero)
    -> (dx, ddt, dB, dC, dA_log, dD, dh0, ddt_bias, dz), each shaped and
    typed like its operand (None for dt_bias and z in the TPU form).

    An explicit reverse scan in fp32, the backward kernel's maths: the
    states h_{t-1} before every token recomputed forward from h0 (kept
    whole here), then, from t = T - 1 down, with delta the step size (the
    fused form's softplus(dt + dt_bias)), e = exp(delta A) and g the
    gradient of the ungated output (dy silu(z) in the fused form):
    dC_t = sum_i g h_t, dD += g x, dh += g C_t, dx = g D + delta sum_s dh
    B_t, dB_t = sum_i dh delta x, d delta = sum_s dh (A e h_{t-1} + x B_t),
    dA += dh delta e h_{t-1}, then dh <- dh e; dA_log = dA A. The fused
    form's d(dt) is d delta times softplus's derivative (sigmoid, 1 past
    softplus's threshold of 20), d(dt_bias) its sum; dz = dy rnd(y)
    silu'(z), rnd the rounding to z's dtype that the forward's gate
    reads."""
    N, T, dI = x.shape
    dS = A_log.shape[-1]
    fused = z is not None
    A = _rows(-torch.exp(A_log.float()), N, 2)                  # [N, dI, dS]
    Dr = _rows(D, N, 1)                                         # [N, dI]
    x32, B32, C32 = x.float(), Bt.float(), Ct.float()
    if fused:
        u = dt.float() + _rows(dt_bias, N, 1)[:, None]
        delta = torch.nn.functional.softplus(u)
    else:
        delta = dt.float()
    hs = []
    h = h0.float()
    for t in range(T):
        hs.append(h)
        h = torch.exp(delta[:, t, :, None] * A) * h + (delta[:, t] * x32[:, t])[..., None] \
            * B32[:, t, None, :]
    dy32 = dy.float()
    if fused:
        zf = z.float()
        sz = torch.sigmoid(zf)
        g = dy32 * (zf * sz)
        yraw = torch.empty(N, T, dI, dtype=torch.float32, device=x.device)
    else:
        g = dy32
    dh = (torch.zeros(N, dI, dS, dtype=torch.float32, device=x.device) if dhT is None
          else dhT.float().clone())
    dx = torch.empty(N, T, dI, dtype=torch.float32, device=x.device)
    dd = torch.empty(N, T, dI, dtype=torch.float32, device=x.device)
    dB = torch.empty(N, T, dS, dtype=torch.float32, device=x.device)
    dC = torch.empty(N, T, dS, dtype=torch.float32, device=x.device)
    dA = torch.zeros(N, dI, dS, dtype=torch.float32, device=x.device)
    dDr = torch.zeros(N, dI, dtype=torch.float32, device=x.device)
    for t in reversed(range(T)):
        hp, d_t, x_t, g_t = hs[t], delta[:, t], x32[:, t], g[:, t]
        e = torch.exp(d_t[..., None] * A)
        ht = e * hp + (d_t * x_t)[..., None] * B32[:, t, None, :]
        if fused:
            yraw[:, t] = torch.einsum("nis,ns->ni", ht, C32[:, t]) + Dr * x_t
        dC[:, t] = torch.einsum("nis,ni->ns", ht, g_t)
        dDr += g_t * x_t
        dh = dh + g_t[..., None] * C32[:, t, None, :]
        dx[:, t] = g_t * Dr + d_t * torch.einsum("nis,ns->ni", dh, B32[:, t])
        dB[:, t] = torch.einsum("nis,ni->ns", dh, d_t * x_t)
        dd[:, t] = (dh * (A * e * hp + x_t[..., None] * B32[:, t, None, :])).sum(-1)
        dA += dh * d_t[..., None] * e * hp
        dh = dh * e
    dA_log = group_sum(dA * A, A_log).to(A_log.dtype)
    dD = group_sum(dDr, D).to(D.dtype)
    ddt_bias = dz = None
    if fused:
        du = dd * torch.where(u > 20, torch.ones_like(u), torch.sigmoid(u))
        dd = du
        ddt_bias = group_sum(du.sum(1), dt_bias).to(dt_bias.dtype)
        yr = yraw.to(z.dtype).float()
        dz = (dy32 * yr * sz * (1 + zf * (1 - sz))).to(z.dtype)
    return (dx.to(x.dtype), dd.to(dt.dtype), dB.to(Bt.dtype), dC.to(Ct.dtype), dA_log, dD,
            dh.to(h0.dtype), ddt_bias, dz)


__all__ = ["needs_grad", "act_grad", "grouped_matmul_bwd", "flash_attention_bwd",
           "armt_read_bwd", "armt_update_bwd", "dpfp_fwd", "dpfp_bwd", "proj", "proj_bwd",
           "group_sum", "mamba_scan_bwd_plain"]
