"""Mixture-of-Experts FFN with argsort-based fixed-capacity dispatch (the
reference's ``global`` and ``per_row`` dispatch).

Each dispatch group of N tokens routes every token to its top-k of E
experts (an fp32 router product and softmax, the top-k gates renormalised
with a 1e-9 guard), sorts the (token, k) pairs by expert with a stable
sort, so that ties rank by token, and gives each expert the first C of its
pairs, C = ``capacity(N)``; the others are dropped. The kept pairs fill an
``[E, C, D]`` buffer, the experts (SwiGLU, weights stacked ``[E, D, F]``)
run over it, and each token sums its pairs' outputs times their gates;
the shared expert, where there is one, is added to that.

The capacity edge is the reference's. It clamps every pair past rank C - 1
onto row C - 1 of its expert, zeroes those pairs, and scatters the pairs
into the buffer; the last write of a duplicate index wins, so in an expert
that received more than C pairs row C - 1 holds zeros, and its rank C - 1
pair is dropped too. Such an expert keeps C - 1 pairs. The port computes
that function without a scatter of duplicate indices (whose order CUDA does
not define either): a pair is kept when its rank is below C, or below C - 1
where its expert overflows, and the buffer is gathered row by row from the
kept pairs.

``moe_tokens`` runs Q dispatch groups at once (``x [Q, N, D]``), each with
its own capacity and router, the experts through a caller's function: the
plain version (``moe_ffn``: torch matmuls, the reference's einsums) or the
fused cell's grouped GEMMs over ``[Q·E, C, D]`` (``moe_ffn_grouped``, which
the ``attn_moe`` cell of ``models/grouped_blocks.py`` runs).
What a group computes does not depend on Q: the router product runs one
matmul per group, and the sums over the K pairs run in a fixed order.
Each pair's output times its gate is rounded to x's dtype, as the
reference's product is; the K products are summed in fp32 and rounded
once.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from repro_torch.configs import DISPATCHES, MoEConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import swiglu


def round_up(x: int, m: int) -> int:
    """Smallest multiple of m that is >= x."""
    return ((x + m - 1) // m) * m


def capacity(n_tokens: int, mcfg: MoEConfig) -> int:
    """Rows per expert of a dispatch over n_tokens: k/E of the (token, k)
    pairs times the capacity factor, rounded up to 8, at least 8."""
    c = int(n_tokens * mcfg.top_k * mcfg.capacity_factor / mcfg.n_experts)
    return max(8, round_up(c, 8))


def check_dispatch(mcfg: MoEConfig) -> None:
    if mcfg.dispatch not in DISPATCHES:
        raise ValueError(f"MoE dispatch {mcfg.dispatch!r} is not ported (the port has "
                         f"{DISPATCHES}; 'einsum' is the reference mesh path's form)")


def moe_param_init(D: int, mcfg: MoEConfig, n: int, nrm, nrm32) -> Dict:
    """Stacked MoE leaves of n layers in the reference layout and scales:
    ``router`` [n, D, E] fp32 (``nrm32``), the experts ``wg``/``wu`` [n, E,
    D, F] and ``wd`` [n, E, F, D], and ``shared`` (a SwiGLU of d_shared)
    where the config has one. nrm(shape, scale) draws in the model dtype."""
    E, F, s = mcfg.n_experts, mcfg.d_expert, D ** -0.5
    p = {"router": nrm32((n, D, E), s), "wg": nrm((n, E, D, F), s),
         "wu": nrm((n, E, D, F), s), "wd": nrm((n, E, F, D), F ** -0.5)}
    if mcfg.d_shared:
        Fs = mcfg.d_shared
        p["shared"] = {"wg": nrm((n, D, Fs), s), "wu": nrm((n, D, Fs), s),
                       "wd": nrm((n, Fs, D), Fs ** -0.5)}
    return p


class Routing(NamedTuple):
    """One call's routing, Q dispatch groups of N tokens, capacity C:
    gate [Q,N,K] fp32 (renormalised), eidx [Q,N,K] (the top-k experts,
    largest gate first), keep [Q,N,K] (the pair holds a buffer row), slot
    [Q,N,K] (that row, e * C + rank, clamped to the expert's last row),
    src [Q,E*C] (the token each buffer row holds) and valid [Q,E*C] (the
    row holds one)."""
    gate: torch.Tensor
    eidx: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    src: torch.Tensor
    valid: torch.Tensor


def _sum_last(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, left to right (an order no reduction kernel
    picks for the shape)."""
    acc = t[..., 0]
    for k in range(1, t.shape[-1]):
        acc = acc + t[..., k]
    return acc


def route(x: torch.Tensor, router, mcfg: MoEConfig, C: int) -> Routing:
    """x: [Q, N, D]; router: Q fp32 [D, E] matrices (a [Q, D, E] tensor).
    The router product is one fp32 matmul per group, so its bits do not
    depend on Q (TF32 must be off, PyTorch's default)."""
    Q, N, _ = x.shape
    E, K = mcfg.n_experts, mcfg.top_k
    x32 = x.float()
    logits = torch.stack([torch.matmul(x32[q], router[q].float()) for q in range(Q)])
    gate, eidx = torch.topk(torch.softmax(logits, dim=-1), K, dim=-1)
    gate = gate / (_sum_last(gate) + 1e-9)[..., None]
    flat = eidx.reshape(Q, N * K)
    sorted_e, order = torch.sort(flat, dim=-1, stable=True)
    experts = torch.arange(E, device=x.device).expand(Q, E).contiguous()
    starts = torch.searchsorted(sorted_e, experts)                          # [Q, E]
    counts = torch.searchsorted(sorted_e, experts, right=True) - starts
    # rows an expert keeps: C, or C - 1 when it overflows (the capacity edge)
    kept = torch.minimum(counts, C - (counts > C).long())
    rank = (torch.arange(N * K, device=x.device)[None]
            - starts.gather(1, sorted_e))                                   # sorted order
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(N * K, device=x.device).expand(Q, N * K).contiguous())
    rank_p = rank.gather(1, inv)                                            # pair order
    keep = rank_p < kept.gather(1, flat)
    slot = flat * C + rank_p.clamp_max(C - 1)
    row = torch.arange(C, device=x.device)
    valid = (row[None, None] < kept[:, :, None]).reshape(Q, E * C)
    j = (starts[:, :, None] + row[None, None]).reshape(Q, E * C).clamp_max(N * K - 1)
    src = order.gather(1, j) // K
    return Routing(gate, eidx, keep.reshape(Q, N, K), slot.reshape(Q, N, K), src, valid)


def moe_tokens(x: torch.Tensor, router, mcfg: MoEConfig,
               experts: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The routed experts over Q dispatch groups: x [Q, N, D] -> [Q, N, D]
    in x.dtype, without the shared expert. experts(buf [Q, E, C, D]) ->
    [Q, E, C, D] in x.dtype applies each group's experts to its buffer."""
    Q, N, D = x.shape
    E, K = mcfg.n_experts, mcfg.top_k
    C = capacity(N, mcfg)
    r = route(x, router, mcfg, C)
    buf = x.gather(1, r.src[..., None].expand(Q, E * C, D))
    buf.masked_fill_(~r.valid[..., None], 0)
    out = experts(buf.view(Q, E, C, D)).reshape(Q, E * C, D)
    del buf
    acc = None
    for k in range(K):
        yk = out.gather(1, r.slot[:, :, k, None].expand(Q, N, D))
        yk.masked_fill_(~r.keep[:, :, k, None], 0)
        term = (yk * r.gate[:, :, k, None].to(x.dtype)).float()
        acc = term if acc is None else acc.add_(term)
    return acc.to(x.dtype)


def plain_experts(p: Dict) -> Callable[[torch.Tensor], torch.Tensor]:
    """One layer's experts as torch matmuls over buf [Q, E, C, D] (the
    reference's einsums): (silu(buf wg) * buf wu) wd, in the activation
    dtype."""
    def experts(buf):
        g = torch.matmul(buf, p["wg"])
        u = torch.matmul(buf, p["wu"])
        return torch.matmul(torch.nn.functional.silu(g) * u, p["wd"])
    return experts


def moe_ffn(x: torch.Tensor, p: Dict, mcfg: MoEConfig) -> torch.Tensor:
    """The plain MoE FFN of one layer: x [B, T, D] -> [B, T, D]. 'global'
    dispatches all B*T tokens at once (capacity over B*T), 'per_row' each
    batch row alone."""
    check_dispatch(mcfg)
    B, T, D = x.shape
    if mcfg.dispatch == "per_row" and B > 1:
        xq, router = x, p["router"].expand(B, -1, -1)
    else:
        xq, router = x.reshape(1, B * T, D), p["router"][None]
    y = moe_tokens(xq, router, mcfg, plain_experts(p)).reshape(B, T, D)
    if "shared" in p:
        y = y + swiglu(x, p["shared"])
    return y


def moe_ffn_grouped(x: torch.Tensor, p: Dict, mcfg: MoEConfig, widx=None) -> torch.Tensor:
    """The MoE FFN of a band of G layers on the grouped GEMM: x [G, B, T, D]
    -> [G, B, T, D], each group dispatched alone as the reference's vmap over
    the band does ('global': one dispatch of B*T tokens a group; 'per_row':
    one per group and batch row at B > 1). p: the band's MoE leaves
    ([G, ...]), or with widx (int32 [G] on the device) the whole stack, group
    i being layer widx[i].

    The expert products are three grouped GEMMs over [Q*E, C, D] against
    the view [Lw*E, D, F] of the stacked experts, the silu on the gate
    product's epilogue; group (q, e) reads expert lw[q]*E + e of the
    flattened stack through the GEMM's layer index, where lw is widx (per
    row: repeated over the rows), and the band's own view needs none. The
    shared expert is three more grouped GEMMs over [G, B*T, D]. The router
    (fp32, gathered with widx) and the dispatch are torch ops."""
    check_dispatch(mcfg)
    G, B, T, D = x.shape
    E, F = mcfg.n_experts, mcfg.d_expert
    R = B if mcfg.dispatch == "per_row" and B > 1 else 1
    lw = widx
    if lw is None and R > 1:
        lw = torch.arange(G, dtype=torch.int32, device=x.device)
    eidx = None     # the band's experts, viewed [G * E, D, F]
    if lw is not None:
        eidx = (lw[:, None] * E + torch.arange(E, dtype=torch.int32, device=x.device)
                ).repeat_interleave(R, dim=0).reshape(-1)
    router = p["router"] if widx is None else p["router"].index_select(0, widx)
    if R > 1:
        router = router.repeat_interleave(R, dim=0)

    def experts(buf):   # [Q, E, C, D] -> [Q, E, C, D]
        Q, _, C, _ = buf.shape
        xb = buf.reshape(Q * E, C, D)
        g = kops.grouped_gemm(xb, p["wg"].reshape(-1, D, F), activation="silu", widx=eidx)
        g.mul_(kops.grouped_gemm(xb, p["wu"].reshape(-1, D, F), widx=eidx))
        return kops.grouped_gemm(g, p["wd"].reshape(-1, F, D), widx=eidx).reshape(Q, E, C, D)

    y = moe_tokens(x.reshape(G * R, B * T // R, D), router, mcfg, experts).reshape(x.shape)
    if "shared" in p:
        ps = p["shared"]
        gate = kops.grouped_gemm(x, ps["wg"], activation="silu", widx=widx)
        y = y + kops.grouped_gemm(gate * kops.grouped_gemm(x, ps["wu"], widx=widx), ps["wd"],
                                  widx=widx)
    return y


def aux_load_balance_loss(x: torch.Tensor, p: Dict, mcfg: MoEConfig) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss of x [B, T, D] under the
    router ``p["router"]`` [D, E]: E * sum_e (share of the top-k picks on e)
    * (mean router probability of e), fp32; 1 when uniform. The
    reference's ``lm_loss`` does not add it either."""
    logits = torch.matmul(x.float().reshape(-1, x.shape[-1]), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    eidx = torch.topk(probs, mcfg.top_k, dim=-1).indices
    onehot = torch.nn.functional.one_hot(eidx, mcfg.n_experts).sum(1).float()   # [N, E]
    frac_tokens = onehot.mean(0) / mcfg.top_k
    return mcfg.n_experts * (frac_tokens * probs.mean(0)).sum()
