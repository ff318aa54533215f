"""jamba-1.5-large-398b — Mamba+attention 1:7 interleave with MoE.

[hybrid] 72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2
[arXiv:2403.19887; hf]

Superblock of 8 layers: 1 attention + 7 mamba; MoE on every other layer
(4 of 8). 9 superblocks = 72 layers, 9 attention : 63 mamba = 1:7.
Mamba layers are PRMT members (layer-local h state), so diagonal batching
covers the whole heterogeneous stack via static slot-type partitioning.
"""
from repro_torch.configs import ArchConfig, ARMTConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab=65536,
    block_pattern=("attn", "mamba_moe", "mamba", "mamba_moe",
                   "mamba", "mamba_moe", "mamba", "mamba_moe"),
    norm="rmsnorm",
    act="silu",
    use_rope=False,        # jamba attention layers use no positional encoding
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576, d_shared=0,
                  capacity_factor=1.25),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    armt=ARMTConfig(segment_len=1024, num_mem_tokens=128, d_mem=64),
    source="arXiv:2403.19887; hf",
)
