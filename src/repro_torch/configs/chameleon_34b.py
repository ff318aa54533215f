"""chameleon-34b — early-fusion VLM with VQ image tokens.

[vlm] 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536
[arXiv:2405.09818; unverified]

Early fusion: image VQ tokens share the text vocab, so the backbone is a dense
LM over token ids; the image tokenizer frontend is a stub in the reference too.
Chameleon uses QK-norm for training stability — kept here.
"""
from repro_torch.configs import ArchConfig, ARMTConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22016,
    vocab=65536,
    block_pattern=("attn",),
    norm="rmsnorm",
    act="silu",
    qk_norm=True,
    rope_theta=10000.0,
    armt=ARMTConfig(segment_len=1024, num_mem_tokens=128, d_mem=64),
    source="arXiv:2405.09818; unverified",
)
