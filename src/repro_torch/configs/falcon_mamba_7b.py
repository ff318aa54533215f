"""falcon-mamba-7b: a pure Mamba-1 stack (attention-free).

[ssm] 64L d_model=4096 (attn-free) d_ff=0 vocab=65024, ssm_state=16
[arXiv:2410.05355; unverified]

Each layer's recurrent state is the SSM hidden state h plus the causal-conv
tail, carried across segments, so the diagonal executor schedules the
64-layer x n_segments grid exactly as for ARMT. No associative memory
(armt=None): the SSM state is the layer memory.
"""
from repro_torch.configs import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    block_pattern=("mamba",),
    norm="rmsnorm",
    act="silu",
    use_rope=False,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    armt=None,             # SSM state is the layer-local memory
    source="arXiv:2410.05355; unverified",
)

# Segment length when falcon-mamba runs segmented (diagonal or sequential):
# no memory tokens, the segment is purely a scheduling unit.
SEGMENT_LEN = 1024
