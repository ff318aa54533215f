"""chatglm3-6b — 2D (partial) RoPE, strongly-grouped GQA.

[dense] 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024
[arXiv:2406.12793; hf]
"""
from repro_torch.configs import ArchConfig, ARMTConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_head=128,
    d_ff=13696,
    vocab=65024,
    block_pattern=("attn",),
    norm="rmsnorm",
    act="silu",
    qkv_bias=True,          # chatglm uses bias on QKV
    rope_theta=10000.0,
    rope_fraction=0.5,      # "2d" rope: rotary on half the head dims
    armt=ARMTConfig(segment_len=1024, num_mem_tokens=128, d_mem=64),
    source="arXiv:2406.12793; hf",
)
