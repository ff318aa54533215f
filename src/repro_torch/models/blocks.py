"""The port's block types and their layer-local state.

  attn   pre-norm attention + SwiGLU FFN + ARMT memory (A, z)
  mamba  pre-norm Mamba-1 mixer (SSM state h and the conv tail)

``make_apply_block(cfg)`` binds ``apply_block(btype, p, x, state) -> (y,
new_state)``, the signature both executors share. The attn block reads the
memory into the segment, runs attention and the FFN, then the delta-rule
update from the last M rows of the block output (paper eq. 2).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.memory import mem_read, mem_state_init, mem_update
from repro_torch.models.attention import attention
from repro_torch.models.layers import rmsnorm, swiglu
from repro_torch.models.mamba import mamba_block, mamba_state_init


def block_state_init(t: str, cfg, batch: int, device, dtype) -> Dict:
    """Layer-local recurrent state for segmented execution: fp32 A, z
    (attn), or fp32 h and a conv tail in ``dtype`` (mamba)."""
    if t == "attn":
        return mem_state_init(batch, cfg.d_model, cfg.armt, device)
    if t == "mamba":
        return mamba_state_init(batch, cfg.d_model, cfg.ssm, dtype, device)
    raise ValueError(f"unknown block type {t!r}")


def make_apply_block(cfg):
    def apply_block(t: str, p, x, state):
        if t == "mamba":
            return mamba_block(p, x, cfg.ssm, state)
        if t != "attn":
            raise ValueError(f"unknown block type {t!r}")
        new_state = dict(state)
        M = cfg.armt.num_mem_tokens
        x = x + mem_read(p["mem"], state, x, cfg.armt)
        h = x + attention(rmsnorm(x, p["ln1"]), p["attn"], cfg)
        y = h + swiglu(rmsnorm(h, p["ln2"]), p["ffn"])
        if M > 0:
            new_state.update(mem_update(p["mem"], {"A": state["A"], "z": state["z"]},
                                        y[:, -M:, :], cfg.armt))
        return y, new_state

    return apply_block
