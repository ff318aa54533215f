"""qwen2-moe-a2.7b — 60 routed experts top-4 + shared expert.

[moe] 24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936, MoE 60e top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

The "4 shared" experts are modeled as one shared FFN of 4*1408 = 5632
(matching hf shared_expert_intermediate_size).
"""
from repro_torch.configs import ArchConfig, ARMTConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,         # MHA
    d_head=128,
    d_ff=1408,             # per-expert intermediate (assignment value)
    vocab=151936,
    block_pattern=("attn_moe",),
    norm="rmsnorm",
    act="silu",
    qkv_bias=True,
    rope_theta=1000000.0,
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408, d_shared=5632,
                  capacity_factor=1.25),
    armt=ARMTConfig(segment_len=1024, num_mem_tokens=128, d_mem=64),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)
