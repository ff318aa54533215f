"""whisper-medium — encoder–decoder with a stub frontend.

[audio] 24 + 24 layers, d_model 1024, 16 heads of 64 (MHA), d_ff 4096,
vocab 51865 [arXiv:2212.04356; unverified]

The conv frontend is a stub: callers pass frame embeddings [B, 1500,
d_model]. The encoder (bidirectional, no memory) runs all frames at once;
the decoder's ``dec`` layers are ARMT layers with cross-attention to the
encoder's K/V, which they carry as constant state.
"""
from repro_torch.configs import ArchConfig, ARMTConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,             # decoder layers; the encoder's below
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab=51865,
    block_pattern=("dec",),  # self-attention, cross-attention, GELU MLP
    norm="layernorm",
    act="gelu",
    use_rope=False,          # learned position embeddings
    encoder=EncoderConfig(n_layers=24, n_frames=1500),
    armt=ARMTConfig(segment_len=1024, num_mem_tokens=128, d_mem=64),
    source="arXiv:2212.04356; unverified",
)
