"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

[dense] 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000
[arXiv:2401.16818; hf]
"""
from repro_torch.configs import ArchConfig, ARMTConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=80,             # 2560 / 32
    d_ff=6912,
    vocab=32000,
    block_pattern=("attn",),
    norm="rmsnorm",
    act="silu",
    rope_theta=10000.0,
    sliding_window=4096,   # mistral-style SWA; >= ARMT segment => full attn per segment
    tie_embeddings=True,
    armt=ARMTConfig(segment_len=1024, num_mem_tokens=128, d_mem=64),
    source="arXiv:2401.16818; hf",
)
