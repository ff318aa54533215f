"""Attention: GQA self-attention over a segment, causal or bidirectional
(the dense plain path the flash-attention kernel is held against), the
KV-cache decode attention, whose single-token step runs the
decode-attention kernel, and whisper's cross-attention to the encoder's
K/V: plain (``cross_attention``) and on the kernels for decode
(``decode_cross_attention``)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, rmsnorm, rope_cos_sin, rope_dims

NEG_INF = -1e30


def _project_qkv(x, p, cfg):
    """q [B,T,Hq,hd], k/v [B,T,Hkv,hd]: the projections, plus ``bq/bk/bv``
    where the layer has them (``cfg.qkv_bias``), then the per-head RMSNorm
    of q and k with ``qn``/``kn`` (``cfg.qk_norm``), before any rotary."""
    B, T, _ = x.shape
    hd = cfg.head_dim

    def proj(w, b, heads):
        y = torch.matmul(x, p[w])
        if b in p:
            y = y + p[b]
        return y.reshape(B, T, heads, hd)
    q = proj("wq", "bq", cfg.n_heads)
    k = proj("wk", "bk", cfg.n_kv_heads)
    v = proj("wv", "bv", cfg.n_kv_heads)
    if cfg.qk_norm:
        q, k = rmsnorm(q, p["qn"]), rmsnorm(k, p["kn"])
    return q, k, v


def rope_qk(q, k, cfg, positions=None):
    """RoPE on q/k [..., T, H, hd] from one cos/sin table, over the leading
    ``cfg.rope_fraction`` of the head dims; positions default to the
    segment-local arange(T). Shared by the plain block, the fused grouped
    cell and decode, so the rotary math is identical. With
    ``cfg.use_rope`` off (jamba) q and k pass through unrotated."""
    if not cfg.use_rope:
        return q, k
    if positions is None:
        positions = torch.arange(q.shape[-3], device=q.device)[None]
    cos, sin = rope_cos_sin(positions, rope_dims(cfg.head_dim, cfg.rope_fraction),
                            cfg.rope_theta)
    return (apply_rope(q, cos, sin, cfg.rope_fraction),
            apply_rope(k, cos, sin, cfg.rope_fraction))


def sdpa(q, k, v, mask=None) -> torch.Tensor:
    """q: [B,T,Hq,hd], k/v: [B,S,Hkv,hd] (GQA: kv head = h // rep), fp32
    softmax."""
    hd = q.shape[-1]
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bthd,bshd->bhts", q, k).float() * hd ** -0.5
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", w, v)


def causal_mask(T: int, S: int, *, offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """[1,1,T,S] bool; query t attends key s iff s <= t+offset (and within
    the sliding window if window > 0)."""
    qpos = torch.arange(T, device=device)[:, None] + offset
    kpos = torch.arange(S, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > (qpos - window)
    return m[None, None]


def attention(x, p, cfg, *, causal: bool = True):
    """Self-attention over x [B,T,D] (a full segment, positions 0..T-1, no
    cache): causal, or bidirectional with causal=False (whisper's
    encoder)."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg)
    q, k = rope_qk(q, k, cfg)
    mask = causal_mask(T, T, window=cfg.sliding_window, device=x.device) if causal else None
    o = sdpa(q, k, v, mask).reshape(B, T, cfg.n_heads * cfg.head_dim)
    return torch.matmul(o, p["wo"])


def _cross_q(x, p, cfg):
    q = torch.matmul(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    return q.reshape(x.shape[0], x.shape[1], cfg.n_heads, cfg.head_dim)


def cross_attention(x, p, ck, cv, cfg):
    """x [B,T,D] against the encoder's K/V ck/cv [B,F,Hkv,hd], every frame
    visible: the plain path (sdpa)."""
    B, T, _ = x.shape
    o = sdpa(_cross_q(x, p, cfg), ck, cv).reshape(B, T, cfg.n_heads * cfg.head_dim)
    return torch.matmul(o, p["wo"])


def decode_cross_attention(x, p, ck, cv, cfg):
    """``cross_attention`` on the kernels, for decode: one token through
    ``kops.decode_attention`` with every row's length F (the reference's
    sdpa over all frames), a chunk (the flush's memory tokens, a prompt
    tail) through ``kops.flash_attention`` without a mask, both reading
    ck/cv [B,F,Hkv,hd] through their strides."""
    B, Tq, _ = x.shape
    q = _cross_q(x, p, cfg)
    if Tq == 1:
        lens = torch.full((B,), ck.shape[1], dtype=torch.int32, device=x.device)
        o = kops.decode_attention(q[:, 0], ck, cv, lens)
    else:
        o = kops.flash_attention(q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2),
                                 causal=False).transpose(1, 2)
    return torch.matmul(o.reshape(B, Tq, cfg.n_heads * cfg.head_dim), p["wo"])


def cross_kv(enc_out, p, cfg):
    """The cross-attention K/V of one decoder layer from the encoder's output
    [B,F,D] -> (ck, cv) [B,F,Hkv,hd], biases included: the plain path."""
    B, F, _ = enc_out.shape

    def proj(w, b):
        y = torch.matmul(enc_out, p[w])
        if b in p:
            y = y + p[b]
        return y.reshape(B, F, cfg.n_kv_heads, cfg.head_dim)
    return proj("wk", "bk"), proj("wv", "bv")


def _write_rows(cache: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
                mask=None) -> None:
    """In place: cache [B,S,H,hd] row pos[b] + t of batch row b takes rows[b,
    t] ([B,Tq,H,hd]). Positions past the cache are clamped to its last row,
    as the reference's dynamic_update_slice clamps. With mask (bool [B]) a
    row where it is False gets its own old values back, bit for bit."""
    B, S = cache.shape[:2]
    Tq = rows.shape[1]
    at = (pos[:, None] + torch.arange(Tq, device=cache.device)[None]).clamp_max(S - 1)
    idx = (at + torch.arange(B, device=cache.device)[:, None] * S).reshape(-1)
    flat = cache.view((B * S,) + tuple(cache.shape[2:]))
    rows = rows.reshape((B * Tq,) + tuple(rows.shape[2:])).to(cache.dtype)
    if mask is not None:
        keep = mask[:, None].expand(B, Tq).reshape((-1,) + (1,) * (rows.dim() - 1))
        rows = torch.where(keep, rows, flat.index_select(0, idx))
    flat.index_copy_(0, idx, rows)


def decode_attention(x, p, cfg, cache: Dict, pos, mask=None):
    """Tq >= 1 queries against a KV cache, which it updates in place: the
    new k/v rows are written at positions pos..pos+Tq-1. x: [B,Tq,D]; pos:
    Python int (tokens already in the cache) or int64 tensor [B] of per-row
    positions, read on the device; mask: optional bool [B] with a per-row
    pos, the rows whose cache takes the new rows (the others keep theirs,
    bit for bit, and their outputs are to be discarded). Returns the
    attention output [B,Tq,D].

    A single token (the serve hot path) goes through ``kops.decode_attention``
    with per-row lengths pos + 1, which reads only each row's valid cache
    prefix. On the card a chunk that starts the cache (scalar pos 0: a
    cache-mode prompt, an ARMT prompt tail) goes through
    ``kops.flash_attention`` over the rows it just wrote: causal with T = S
    = Tq is the masked function, since every key at or past Tq is masked. It
    raises where the kernel refuses the operands. Every other chunk (the
    memory-token flush at pos != 0, per-slot chunks) and every chunk on the
    CPU takes the masked ``sdpa``, as the reference does."""
    B, Tq, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg)
    ck, cv = cache["k"], cache["v"]
    S = ck.shape[1]
    per_slot = isinstance(pos, torch.Tensor)
    if mask is not None and not per_slot:
        raise ValueError("decode_attention(mask=...) needs a per-row pos tensor")
    if per_slot:
        positions = pos[:, None] + torch.arange(Tq, device=x.device)[None]
        q, k = rope_qk(q, k, cfg, positions)
        _write_rows(ck, k, pos, mask)
        _write_rows(cv, v, pos, mask)
    else:
        q, k = rope_qk(q, k, cfg, (pos + torch.arange(Tq, device=x.device))[None])
        ck[:, pos:pos + Tq] = k
        cv[:, pos:pos + Tq] = v
    if Tq == 1:
        # a frozen row may sit at the cache's end; its output is discarded
        lens = ((pos + 1).clamp_max(S).to(torch.int32) if per_slot else
                torch.full((B,), pos + 1, dtype=torch.int32, device=x.device))
        o = kops.decode_attention(q[:, 0], ck, cv, lens, window=cfg.sliding_window)
    elif not per_slot and pos == 0 and x.device.type != "cpu":
        o = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 causal=True, window=cfg.sliding_window).transpose(1, 2)
    elif per_slot:
        qpos = positions[:, :, None]                               # [B,Tq,1]
        kpos = torch.arange(S, device=x.device)[None, None, :]
        mask_ = kpos <= qpos
        if cfg.sliding_window > 0:
            mask_ &= kpos > (qpos - cfg.sliding_window)
        o = sdpa(q, ck, cv, mask_[:, None])                        # [B,1,Tq,S]
    else:
        o = sdpa(q, ck, cv, causal_mask(Tq, S, offset=pos, window=cfg.sliding_window,
                                        device=x.device))
    o = o.reshape(B, Tq, cfg.n_heads * cfg.head_dim)
    return torch.matmul(o, p["wo"])
