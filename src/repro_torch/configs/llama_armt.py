"""The paper's own model family: Llama-3.2/3.1 + ARMT, with
(segment_size, memory_tokens) = (1024, 128) and d_mem = 64."""
from repro_torch.configs import ArchConfig, ARMTConfig

_ARMT = ARMTConfig(segment_len=1024, num_mem_tokens=128, d_mem=64)

CONFIGS = {
    "llama-160m-armt": ArchConfig(
        name="llama-160m-armt", family="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_head=64,
        d_ff=3072, vocab=32000, block_pattern=("attn",),
        norm="rmsnorm", act="silu", rope_theta=10000.0,
        tie_embeddings=True, armt=_ARMT, source="paper Table 7"),
    "llama-1b-armt": ArchConfig(
        name="llama-1b-armt", family="dense",
        n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_head=64,
        d_ff=8192, vocab=128256, block_pattern=("attn",),
        norm="rmsnorm", act="silu", rope_theta=500000.0,
        tie_embeddings=True, armt=_ARMT, source="Llama-3.2-1B; paper Table 1"),
    "llama-3b-armt": ArchConfig(
        name="llama-3b-armt", family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_head=128,
        d_ff=8192, vocab=128256, block_pattern=("attn",),
        norm="rmsnorm", act="silu", rope_theta=500000.0,
        tie_embeddings=True, armt=_ARMT, source="Llama-3.2-3B; paper Table 5"),
    "llama-8b-armt": ArchConfig(
        name="llama-8b-armt", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=14336, vocab=128256, block_pattern=("attn",),
        norm="rmsnorm", act="silu", rope_theta=500000.0,
        armt=_ARMT, source="Llama-3.1-8B; paper Table 6"),
}
