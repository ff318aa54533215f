"""The port's block types and their layer-local state.

  attn       pre-norm attention + SwiGLU FFN + ARMT memory (A, z)
  attn_moe   pre-norm attention + MoE FFN + ARMT memory (A, z)
  mamba      pre-norm Mamba-1 mixer (SSM state h and the conv tail), then
             a SwiGLU FFN when the layer has one (jamba; falcon has none)
  mamba_moe  pre-norm Mamba-1 mixer + MoE FFN (SSM state)
  dec        whisper's decoder layer: pre-norm causal self-attention, then
             cross-attention to the encoder's K/V (``ck``/``cv``, constant
             state), then the GELU MLP + ARMT memory (A, z)
  enc        whisper's encoder layer: bidirectional self-attention + the
             GELU MLP, no memory and no state (``models/model.py``
             ``encode`` runs it; no pattern holds it)

``make_apply_block(cfg, mode)`` binds ``apply_block(btype, p, x, state) ->
(y, new_state)``, the signature both executors share. In ``"segmented"``
mode the attn block reads the memory into the segment, runs attention and
the FFN, then the delta-rule update from the last M rows of the block output
(paper eq. 2); in ``"full"`` mode (the paper's full-attention baseline) it is
a plain transformer block with no memory and no state (a ``dec`` block
keeps its cross K/V). The norm and the dense FFN are ``cfg.norm``'s and
``cfg.act``'s (rmsnorm and SwiGLU; whisper's layernorm and GELU MLP).

With ``cfg.cell_block > 0`` a dense FFN runs blockwise over a segment of
more rows: (norm, FFN) a chunk of ``cell_block`` tokens at a time, the
reference's ``blockwise_ffn`` (it pads the tail chunk and drops it after;
the port slices it, the same rows). Decode never blocks, as the
reference's decode apply does not.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.memory import mem_read, mem_state_init, mem_update
from repro_torch.models.attention import attention, cross_attention
from repro_torch.models.layers import ffn, norm
from repro_torch.models.mamba import mamba_block, mamba_state_init
from repro_torch.models.moe import moe_ffn


MODES = ("segmented", "full")
ATTN_TYPES = ("attn", "attn_moe", "dec")
MAMBA_TYPES = ("mamba", "mamba_moe")


def block_d_ff(cfg, t: str, prelude: bool) -> int:
    """The dense FFN width of a layer: none for a MoE layer, the prelude's
    own width where the config has one (kimi), else ``cfg.d_ff``."""
    if t.endswith("moe"):
        return 0
    if prelude and cfg.prelude_d_ff:
        return cfg.prelude_d_ff
    return cfg.d_ff


def apply_ffn(cfg, t: str, h, p, block: int = 0):
    """The block's FFN with its residual: h + moe_ffn(norm(h)) for a MoE
    layer, h + ffn(norm(h)) for a dense one (SwiGLU, or the GELU MLP), h
    for a layer without FFN (falcon's mamba). block > 0: a dense FFN over
    more than ``block`` tokens runs chunk by chunk (a MoE FFN stays whole:
    its capacity couples the tokens)."""
    if t.endswith("moe"):
        return h + moe_ffn(norm(cfg.norm, h, p["ln2"]), p["moe"], cfg.moe)
    if "ffn" not in p:
        return h
    T = h.shape[-2]
    if 0 < block < T:
        return h + torch.cat([ffn(cfg.act, norm(cfg.norm, h[..., i:i + block, :], p["ln2"]),
                                  p["ffn"]) for i in range(0, T, block)], dim=-2)
    return h + ffn(cfg.act, norm(cfg.norm, h, p["ln2"]), p["ffn"])


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def block_state_init(t: str, cfg, batch: int, device, dtype,
                     mode: str = "segmented") -> Dict:
    """Layer-local state: fp32 A, z (attn, attn_moe and dec, segmented
    mode; none in full mode or without ARMT), or fp32 h and a conv tail in
    ``dtype`` (mamba and mamba_moe, either mode); a dec layer also holds
    its cross K/V ``ck``/``cv`` [batch, n_frames, Hkv, hd] in ``dtype``
    (zeros until filled from the encoder; either mode)."""
    check_mode(mode)
    if t in ATTN_TYPES:
        st = ({} if mode == "full" or cfg.armt is None else
              mem_state_init(batch, cfg.d_model, cfg.armt, device))
        if t == "dec":
            shape = (batch, cfg.encoder.n_frames, cfg.n_kv_heads, cfg.head_dim)
            st["ck"] = torch.zeros(shape, dtype=dtype, device=device)
            st["cv"] = torch.zeros(shape, dtype=dtype, device=device)
        return st
    if t in MAMBA_TYPES:
        return mamba_state_init(batch, cfg.d_model, cfg.ssm, dtype, device)
    raise ValueError(f"unknown block type {t!r}")


def make_apply_block(cfg, mode: str = "segmented"):
    check_mode(mode)
    armt_on = mode == "segmented" and cfg.armt is not None
    M = cfg.armt.num_mem_tokens if armt_on else 0
    cb = cfg.cell_block

    def apply_block(t: str, p, x, state):
        if t in MAMBA_TYPES:
            h, new_state = mamba_block(p, x, cfg.ssm, state)
            return apply_ffn(cfg, t, h, p, cb), new_state
        if t == "enc":
            h = x + attention(norm(cfg.norm, x, p["ln1"]), p["attn"], cfg, causal=False)
            return apply_ffn(cfg, t, h, p, cb), dict(state)
        if t not in ATTN_TYPES:
            raise ValueError(f"unknown block type {t!r}")
        new_state = dict(state)
        if armt_on:
            x = x + mem_read(p["mem"], state, x, cfg.armt)
        h = x + attention(norm(cfg.norm, x, p["ln1"]), p["attn"], cfg)
        if t == "dec":
            h = h + cross_attention(norm(cfg.norm, h, p["ln_x"]), p["xattn"], state["ck"],
                                    state["cv"], cfg)
        y = apply_ffn(cfg, t, h, p, cb)
        if M > 0:
            new_state.update(mem_update(p["mem"], {"A": state["A"], "z": state["z"]},
                                        y[:, -M:, :], cfg.armt))
        return y, new_state

    return apply_block
