"""Architecture configs: the fields of the reference ``ArchConfig`` that the
port's serving paths read; the ``llama-*-armt`` family, the five other dense
ARMT configs (minitron-8b, qwen2.5-32b, chameleon-34b, h2o-danube-1.8b,
chatglm3-6b), the two MoE ARMT configs (qwen2-moe-a2.7b, and
kimi-k2-1t-a32b with its dense prelude layer), the hybrid
``jamba-1.5-large-398b`` (attention without rotary, Mamba layers with a
dense or MoE FFN), ``falcon-mamba-7b`` and the encoder–decoder
``whisper-medium`` (a bidirectional encoder over stub frame embeddings,
ARMT ``dec`` blocks with cross-attention, layernorm, the GELU MLP and
learned positions); the registry in the reference's order, with its four
input shapes (``SHAPES``); and the smoke reduction used by the CPU tests
(a copy; the port never imports the JAX package)."""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Optional, Tuple


DISPATCHES = ("global", "per_row")
REMATS = ("none", "dots", "full")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int              # per-expert FFN hidden size
    d_shared: int = 0          # shared-expert FFN hidden size (0 = no shared expert)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"   # the router is fp32 (weights and product); kept
                                    # for parity with the reference, validate()
                                    # refuses any other value
    # 'global': one dispatch over all B*T tokens of a call (capacity over
    # them); 'per_row': one dispatch per batch row. The reference's
    # 'einsum' (its mesh path's sharding-local form) is not ported.
    dispatch: str = "global"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective SSM."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0           # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class ARMTConfig:
    """Associative Recurrent Memory Transformer (paper eqs. 3-6)."""
    segment_len: int = 1024    # tokens per segment
    num_mem_tokens: int = 128  # memory tokens appended per segment
    d_mem: int = 64            # key dim before DPFP (phi maps to 2*nu*d_mem)
    d_val: int = 0             # value dim of A; 0 -> d_model
    nu: int = 3                # DPFP order


@dataclass(frozen=True)
class EncoderConfig:
    """The encoder stack of an encoder–decoder (whisper). The frontend is a
    stub: callers pass frame embeddings [B, n_frames, d_model]."""
    n_layers: int
    n_frames: int = 1500


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | vlm | moe | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0            # 0 -> d_model // n_heads
    block_pattern: Tuple[str, ...] = ("attn",)
    prelude: Tuple[str, ...] = ()
    norm: str = "rmsnorm"
    act: str = "silu"
    qkv_bias: bool = False      # bias on the q, k and v projections (qwen, chatglm)
    qk_norm: bool = False       # per-head RMSNorm of q and k before rotary (chameleon)
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # rotary on the leading fraction of the head dims (chatglm)
    use_rope: bool = True
    sliding_window: int = 0    # 0 = full causal attention
    tie_embeddings: bool = False
    prelude_d_ff: int = 0       # dense FFN width of the prelude layers (kimi)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    armt: Optional[ARMTConfig] = None
    encoder: Optional[EncoderConfig] = None
    max_position: int = 131072  # rows of the learned position table (whisper)
    dtype: str = "bfloat16"
    # the blockwise cell FFN: a dense FFN runs (norm, FFN) over chunks of
    # this many tokens, so one chunk's F-wide intermediates are live at a
    # time; 0 (the default) runs it whole. A MoE FFN is never blocked.
    cell_block: int = 0
    # activation rematerialisation under gradients: "none" keeps every
    # cell's intermediates for the backward; "full" (and "dots", which the
    # port runs as "full") recomputes each cell in the backward from its
    # inputs (torch.utils.checkpoint), the reference's jax.checkpoint.
    # Forward values are the same either way.
    remat: str = "full"
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def n_superblocks(self) -> int:
        body = self.n_layers - len(self.prelude)
        if body % len(self.block_pattern):
            raise ValueError(f"{self.name}: {body} layers do not tile by "
                             f"pattern {self.block_pattern}")
        return body // len(self.block_pattern)

    @property
    def layer_types(self) -> Tuple[str, ...]:
        return tuple(self.prelude) + tuple(self.block_pattern) * self.n_superblocks

    @property
    def is_recurrent(self) -> bool:
        """True if every layer carries layer-local recurrent state (ARMT's
        A/z, or a Mamba layer's h and conv tail)."""
        return self.armt is not None or all(
            t.startswith("mamba") for t in self.layer_types)

    def validate(self) -> None:
        """Accepts what the port has: ARMT attn blocks (rmsnorm, swiglu,
        rope, with or without QKV bias and q/k norm, rotary on a fraction
        of the head dims), with a dense FFN (``attn``) or a MoE FFN
        (``attn_moe``, global or per-row dispatch), ``attn`` prelude
        layers before a one-position pattern; a pure ``("mamba",)`` stack
        without FFN; a hybrid ARMT pattern of ``attn`` (rotary or none),
        ``mamba`` (a dense FFN when ``d_ff > 0``) and ``mamba_moe``
        positions, without prelude layers; or the audio stack: an encoder
        and a ``("dec",)`` ARMT pattern, layernorm, the GELU MLP and
        learned positions, no rotary."""
        if not (self.d_model > 0 and self.n_layers > 0 and self.vocab > 0):
            raise ValueError(f"{self.name}: non-positive dims")
        if self.cell_block < 0:
            raise ValueError(f"{self.name}: cell_block {self.cell_block} < 0")
        if self.remat not in REMATS:
            raise ValueError(f"{self.name}: remat {self.remat!r}; expected one of {REMATS}")
        types = set(self.layer_types)
        audio = (self.norm, self.act, self.use_rope) == ("layernorm", "gelu", False)
        if self.encoder is not None or "dec" in types:
            if not (types == {"dec"} and not self.prelude and self.encoder is not None
                    and audio and self.armt is not None):
                raise ValueError(f"{self.name}: the port's encoder-decoder is a ('dec',) "
                                 "ARMT pattern with an encoder, layernorm, the GELU MLP "
                                 "and learned positions")
            if self.encoder.n_layers <= 0 or self.encoder.n_frames <= 0:
                raise ValueError(f"{self.name}: bad encoder {self.encoder}")
        elif self.norm != "rmsnorm" or self.act != "silu":
            raise ValueError(f"{self.name}: the port has rmsnorm + swiglu, or layernorm + "
                             "the GELU MLP in the encoder-decoder only")
        if types & {"attn_moe", "mamba_moe"}:
            if self.moe is None:
                raise ValueError(f"{self.name}: MoE layers need cfg.moe")
            if self.moe.dispatch not in DISPATCHES:
                raise ValueError(f"{self.name}: MoE dispatch {self.moe.dispatch!r}; the "
                                 f"port has {DISPATCHES}")
            if self.moe.router_dtype != "float32":
                raise ValueError(f"{self.name}: router_dtype {self.moe.router_dtype!r}; the "
                                 "router is fp32")
            if not 0 < self.moe.top_k <= self.moe.n_experts:
                raise ValueError(f"{self.name}: top_k {self.moe.top_k} of "
                                 f"{self.moe.n_experts} experts")
        if set(self.prelude) - {"attn"} or (self.prelude and len(self.block_pattern) != 1):
            raise ValueError(f"{self.name}: the port takes attn prelude layers before a "
                             f"one-position pattern, got {self.prelude} + "
                             f"{self.block_pattern}")
        if types & {"attn", "attn_moe", "dec"}:
            if self.n_heads <= 0 or self.n_heads % self.n_kv_heads:
                raise ValueError(f"{self.name}: bad head counts")
            if not 0.0 < self.rope_fraction <= 1.0:
                raise ValueError(f"{self.name}: rope_fraction {self.rope_fraction}")
        if types <= {"attn", "attn_moe"}:
            if self.armt is None or not self.use_rope:
                raise ValueError(f"{self.name}: the port's attn block is the "
                                 "ARMT block with rope")
        elif types == {"mamba"}:
            if self.ssm is None or self.armt is not None or self.d_ff:
                raise ValueError(f"{self.name}: the port's mamba block needs "
                                 "cfg.ssm, no ARMT and no FFN")
        elif types <= {"attn", "mamba", "mamba_moe"} and "attn" in types:
            if self.ssm is None or self.armt is None:
                raise ValueError(f"{self.name}: the port's hybrid stack needs cfg.ssm "
                                 "and ARMT")
        elif types != {"dec"}:      # the encoder-decoder is checked above
            raise ValueError(f"{self.name}: the port has attn (dense or MoE), pure "
                             f"mamba, hybrid attn/mamba/mamba_moe or dec stacks only, got "
                             f"{self.layer_types}")
        _ = self.n_superblocks


# ---------------------------------------------------------------------------
# Input shapes (the reference's four, the same for every LM arch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry, in the reference's order
# ---------------------------------------------------------------------------

_ARCH_MODULES = {
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen2.5-32b": "qwen2_5_32b",
    "minitron-8b": "minitron_8b",
    "chatglm3-6b": "chatglm3_6b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "whisper-medium": "whisper_medium",
    "chameleon-34b": "chameleon_34b",
    # the paper's own model family (Llama-3 + ARMT)
    "llama-160m-armt": "llama_armt",
    "llama-1b-armt": "llama_armt",
    "llama-3b-armt": "llama_armt",
    "llama-8b-armt": "llama_armt",
}

ASSIGNED_ARCHS = [
    "h2o-danube-1.8b", "qwen2.5-32b", "minitron-8b", "chatglm3-6b",
    "kimi-k2-1t-a32b", "qwen2-moe-a2.7b", "jamba-1.5-large-398b",
    "falcon-mamba-7b", "whisper-medium", "chameleon-34b",
]


def list_archs():
    """Every arch id, in the reference's order."""
    return list(_ARCH_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    cfg = mod.CONFIGS[arch_id] if hasattr(mod, "CONFIGS") else mod.CONFIG
    cfg.validate()
    return cfg


def get_smoke_config(arch_id: str, *, seq_len: int = 64) -> ArchConfig:
    """The reference's ``get_smoke_config`` reduction: the prelude and two
    superblocks (one of a pattern of 4 or more positions), d_model 32, 4
    heads (at most 2 kv heads) of 8 dims, vocab 256, fp32; ARMT shrunk to 4
    memory tokens of d_mem 8, SSM to d_state 4, MoE to 4 experts (top-k at
    most 2) of 32 wide and a shared expert of 32, dense FFNs (the
    prelude's too) to 64, an encoder to 2 layers over 16 frames, the
    position table to max(2048, seq_len) rows, remat off. The attention flags (QKV
    bias, q/k norm, rotary fraction, sliding window), the norm and
    activation, and the MoE's capacity factor and dispatch are kept."""
    cfg = get_config(arch_id)
    armt = ssm = moe = enc = None
    if cfg.armt is not None:
        armt = replace(cfg.armt, segment_len=max(8, seq_len // 4),
                       num_mem_tokens=4, d_mem=8, d_val=0)
    if cfg.ssm is not None:
        ssm = replace(cfg.ssm, d_state=4, d_conv=4, expand=2)
    if cfg.moe is not None:
        moe = replace(cfg.moe, n_experts=4, top_k=min(2, cfg.moe.top_k), d_expert=32,
                      d_shared=32 if cfg.moe.d_shared else 0)
    if cfg.encoder is not None:
        enc = replace(cfg.encoder, n_layers=2, n_frames=16)
    n_sb = 1 if len(cfg.block_pattern) >= 4 else 2
    return replace(
        cfg,
        n_layers=len(cfg.prelude) + n_sb * len(cfg.block_pattern),
        d_model=32,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_head=8,
        d_ff=64 if cfg.d_ff else 0,
        prelude_d_ff=64 if cfg.prelude_d_ff else 0,
        vocab=256,
        armt=armt,
        moe=moe,
        ssm=ssm,
        encoder=enc,
        max_position=max(2048, seq_len),
        dtype="float32",
        remat="none",
    )
