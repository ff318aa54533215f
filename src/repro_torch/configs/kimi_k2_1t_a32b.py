"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table config).

[moe] 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384e top-8
[arXiv:2501.kimi2; unverified]

DeepSeek-V3-style: one leading dense layer, then 60 MoE layers with one shared
expert. The assigned d_ff=2048 is the per-expert (MoE intermediate) size; the
leading dense layer uses 9*2048=18432 so its FLOPs match an active MoE layer
(top-8 routed + 1 shared).
"""
from repro_torch.configs import ArchConfig, ARMTConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=112,            # 7168 / 64
    d_ff=2048,             # per-expert intermediate (assignment value)
    vocab=163840,
    prelude=("attn",),     # first layer dense
    prelude_d_ff=18432,
    block_pattern=("attn_moe",),
    norm="rmsnorm",
    act="silu",
    rope_theta=50000.0,
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048, d_shared=2048,
                  capacity_factor=1.25),
    armt=ARMTConfig(segment_len=1024, num_mem_tokens=128, d_mem=64),
    source="arXiv:2501.kimi2; unverified",
)
