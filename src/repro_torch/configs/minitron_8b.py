"""minitron-8b — pruned nemotron.

[dense] 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000
[arXiv:2407.14679; hf]
"""
from repro_torch.configs import ArchConfig, ARMTConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=256000,
    block_pattern=("attn",),
    norm="rmsnorm",
    act="silu",
    rope_theta=10000.0,
    armt=ARMTConfig(segment_len=1024, num_mem_tokens=128, d_mem=64),
    source="arXiv:2407.14679; hf",
)
