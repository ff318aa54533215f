"""qwen2.5-32b — GQA with QKV bias.

[dense] 64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064
[hf:Qwen/Qwen2.5-0.5B family; hf]
"""
from repro_torch.configs import ArchConfig, ARMTConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=27648,
    vocab=152064,
    block_pattern=("attn",),
    norm="rmsnorm",
    act="silu",
    qkv_bias=True,
    rope_theta=1000000.0,
    armt=ARMTConfig(segment_len=1024, num_mem_tokens=128, d_mem=64),
    source="hf:Qwen/Qwen2.5-32B; hf",
)
