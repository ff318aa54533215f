"""The model: parameters, the forward under the diagonal or the sequential
schedule (``mode="segmented"``: the ARMT segments with memory;
``mode="full"``: the paper's full-attention baseline, one segment of the
whole prompt and no memory), the training loss (``lm_loss``: the forward
under gradients, then a chunked cross-entropy), and the serving path (``decode_step``;
``serve_mode="armt"``: for ARMT models against the current-segment KV cache,
with ``flush_segment`` at segment boundaries; ``serve_mode="cache"``: plain
full-KV decoding against a cache of ``max_len`` rows). Four block types:
the ARMT ``attn`` block (dense SwiGLU FFN), the ARMT ``attn_moe`` block (MoE
FFN; qwen2-moe, kimi-k2), the ``mamba`` block (falcon-mamba without FFN,
jamba's with a dense FFN) and jamba's ``mamba_moe`` block, whose layer
state (h, conv tail) the executors carry like ARMT's (A, z).

Parameters are a dict tree in the reference layout: ``embed``,
``final_norm``, ``head`` (untied models), ``mem_tokens`` (ARMT),
``prelude``, a tuple of one tree per prelude layer (kimi's dense first
layer; empty for the other configs), and ``pattern``, a tuple with one
dict per pattern position whose leaves are stacked over the ``n_super``
layers on dim 0. Every executor and the decode path run the prelude
layers first, as the reference does.
``Model`` holds such a tree as an ``nn.Module``.

On a mesh (``launch/mesh.py``) ``shard_model`` gives a rank's local view
of the model: its blocks of the params, the local config (heads, d_ff and
the memory's value dim divided by the 'model' axis, the layers by the
'stage' axis), the tensor-parallel context under which the embedding, the
head, the blocks and decode place their collectives, and the stage
context under which the executors run the rank's block of consecutive
layers (``parallel/comm.py``). On a stage mesh the first stage embeds
(the others hold a placeholder of the input's shape, which they never
read), and what leaves the stack (the hidden states, the rows the final
norm and the head read) is the last stage's, broadcast to every rank bit
for bit (``comm.stage_last``); every rank then applies the final norm and
the head, which it holds whole, so that every rank has the same logits
and draws the same tokens.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import replace
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ArchConfig
from repro_torch.core.capture import Program
from repro_torch.core.diagonal import boundary_states_from_capture, grid, run_diagonal
from repro_torch.core.memory import RECURRENT_KEYS, mem_read, mem_update
from repro_torch.core.schedule import StackLayout
from repro_torch.core.sequential import (capture_init, capture_write_, clone_state,
                                         layer_slice, run_sequential, run_sequential_,
                                         training)
from repro_torch.core.sequential import one_layer_cell as _one_layer_cell
from repro_torch.kernels import ops as kops
from repro_torch.models.attention import cross_kv, decode_attention, decode_cross_attention
from repro_torch.models.blocks import (ATTN_TYPES, MAMBA_TYPES, apply_ffn, block_d_ff,
                                       block_state_init, check_mode, make_apply_block)
from repro_torch.models.grouped_blocks import make_grouped_apply
from repro_torch.models.layers import norm
from repro_torch.models.mamba import mamba_block, mamba_param_init
from repro_torch.models.moe import moe_param_init
from repro_torch.parallel import comm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# segment length of a model without ARMT (the reference's fallback): no
# memory tokens, the segment is only the executors' scheduling unit
DEFAULT_SEG_LEN = 1024
SCHEDULES = ("diagonal", "sequential", "auto")
SERVE_MODES = ("armt", "cache")


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA device; without one that raises. The CPU is
    used only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# ---------------------------------------------------------------------------
# Parameters and state
# ---------------------------------------------------------------------------

def _normal(shape, scale, gen, device, dtype):
    """Normal weights drawn in fp32 on the generator's device, then cast and
    moved: with a CPU generator the same seed gives the same weights on
    every device. A stacked leaf ([n_super, ...]) is drawn one layer at a
    time into its destination (a stack of experts, [n_super, E, ...], one
    expert at a time), so the generator's device holds one such fp32 draw,
    not the stack's; on the CPU the values equal one draw of the whole
    stack wherever each draw's size is a multiple of 16 (the CPU
    generator's block). On the meta device nothing is drawn: the leaf has
    its shape and dtype and no storage (``param_specs``)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if len(shape) < 3:
        return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(
            device=device, dtype=dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for j in range(shape[0]):
        if len(shape) < 4:
            out[j].copy_(torch.randn(shape[1:], generator=gen, device=gen.device) * scale)
            continue
        for e in range(shape[1]):
            out[j, e].copy_(torch.randn(shape[2:], generator=gen, device=gen.device)
                            * scale)
    return out


def init_params(cfg: ArchConfig, generator: torch.Generator, *, device=None) -> Dict:
    """Random weights in the reference tree layout and distributions, in
    ``cfg.dtype`` (Mamba's A_log and D and the MoE router in fp32).
    generator: a CPU ``torch.Generator`` (or an int seed), or a generator
    on ``device``, which draws there (much faster for a model of billions
    of weights, other numbers than the CPU generator's). The QKV biases
    start at zero and the q/k norm weights at one, as in the reference.
    Prelude layers are one tree each (leaves without the stack dim), the
    pattern's leaves stacked over its ``n_super`` layers."""
    device = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    layout = StackLayout.from_config(cfg)
    D = cfg.d_model

    def nrm(shape, scale):
        return _normal(shape, scale, generator, device, dtype)

    def nrm32(shape, scale):
        return _normal(shape, scale, generator, device, torch.float32)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def norm_w(*lead):
        """cfg.norm's weights: rmsnorm's w, layernorm's w and b."""
        if cfg.norm == "rmsnorm":
            return {"w": ones(*lead, D)}
        return {"w": ones(*lead, D), "b": zeros(*lead, D)}

    params: Dict = {"embed": nrm((cfg.vocab, D), 0.02), "final_norm": norm_w()}
    if not cfg.tie_embeddings:
        params["head"] = nrm((D, cfg.vocab), D ** -0.5)
    a = cfg.armt
    if a is not None and a.num_mem_tokens > 0:
        params["mem_tokens"] = nrm((a.num_mem_tokens, D), 0.02)
    if not cfg.use_rope and cfg.encoder is not None:
        params["pos_embed"] = nrm((cfg.max_position, D), 0.02)

    def attn_w(n):
        hd, nq, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        s = D ** -0.5
        attn = {"wq": nrm((n, D, nq * hd), s), "wk": nrm((n, D, nkv * hd), s),
                "wv": nrm((n, D, nkv * hd), s), "wo": nrm((n, nq * hd, D), (nq * hd) ** -0.5)}
        if cfg.qkv_bias or cfg.norm == "layernorm":   # layernorm implies the biases
            attn.update(bq=zeros(n, nq * hd), bk=zeros(n, nkv * hd), bv=zeros(n, nkv * hd))
        if cfg.qk_norm:
            attn.update(qn={"w": ones(n, hd)}, kn={"w": ones(n, hd)})
        return attn

    def block(t, n, prelude=False):
        """One block type's leaves stacked over n layers."""
        F = block_d_ff(cfg, t, prelude)

        def ffn():
            if cfg.act == "silu":
                return {"wg": nrm((n, D, F), D ** -0.5), "wu": nrm((n, D, F), D ** -0.5),
                        "wd": nrm((n, F, D), F ** -0.5)}
            out = {"wi": nrm((n, D, F), D ** -0.5), "wo": nrm((n, F, D), F ** -0.5)}
            if cfg.norm == "layernorm":
                out.update(bi=zeros(n, F), bo=zeros(n, D))
            return out
        if t in MAMBA_TYPES:
            out = {"ln1": norm_w(n),
                   "mixer": mamba_param_init(D, cfg.ssm, n, nrm, dtype, device)}
            if t == "mamba_moe":
                out.update(ln2=norm_w(n), moe=moe_param_init(D, cfg.moe, n, nrm, nrm32))
            elif F:
                out.update(ln2=norm_w(n), ffn=ffn())
            return out
        out = {"ln1": norm_w(n), "attn": attn_w(n)}
        if a is not None and t != "enc":   # a plain Llama (no ARMT) has no memory weights
            s = D ** -0.5
            out["mem"] = {"wq": nrm((n, D, a.d_mem), s), "wk": nrm((n, D, a.d_mem), s),
                          "wv": nrm((n, D, a.d_val or D), s), "wb": nrm((n, D, 1), s)}
        if t == "dec":
            out.update(ln_x=norm_w(n), xattn=attn_w(n))
        out["ln2"] = norm_w(n)
        if t == "attn_moe":
            out["moe"] = moe_param_init(D, cfg.moe, n, nrm, nrm32)
        else:
            out["ffn"] = ffn()
        return out

    params["prelude"] = tuple(_tree_map(lambda path, leaf: leaf[0], block(t, 1, True))
                              for t in layout.prelude)
    params["pattern"] = tuple(block(t, layout.n_super) for t in layout.pattern)
    if cfg.encoder is not None:
        e = cfg.encoder
        params["enc"] = {"blocks": block("enc", e.n_layers), "final_norm": norm_w(),
                         "pos": nrm((e.n_frames, D), 0.02)}
    return params


def param_specs(cfg: ArchConfig, dtype=None) -> Dict:
    """The parameter tree's shapes and dtypes without allocation:
    ``init_params`` on the meta device (a 1 T-parameter config costs no
    memory). dtype: the weights' dtype in place of ``cfg.dtype`` (a torch
    dtype or its name), the reference's keyword; the fp32 leaves stay
    fp32."""
    if dtype is not None:
        name = dtype if isinstance(dtype, str) else {v: k for k, v in DTYPES.items()}[dtype]
        cfg = replace(cfg, dtype=name)
    return init_params(cfg, 0, device="meta")


def init_state(cfg: ArchConfig, batch: int, device, dtype=None,
               mode: str = "segmented", cross_from: Optional[Dict] = None) -> Dict:
    """Zero executor state; dtype (default ``cfg.dtype``) is that of the
    Mamba conv tail and of a dec layer's cross K/V, every other leaf is
    fp32. In ``"full"`` mode an attn layer has no state. cross_from: a
    state (executor or decode) whose dec layers' ``ck``/``cv`` this state
    shares (the same tensors, not copies), in place of zeros."""
    dtype = dtype or DTYPES[cfg.dtype]
    layout = StackLayout.from_config(cfg)
    pattern = []
    for p, t in enumerate(layout.pattern):
        st = block_state_init(t, cfg, batch, "meta", dtype, mode)
        pattern.append({k: (cross_from["pattern"][p][k] if cross_from is not None
                            and k in ("ck", "cv") else
                            torch.zeros((layout.n_super,) + tuple(v.shape), dtype=v.dtype,
                                        device=device))
                        for k, v in st.items()})
    prelude = tuple(block_state_init(t, cfg, batch, device, dtype, mode)
                    for t in layout.prelude)
    return {"prelude": prelude, "pattern": tuple(pattern)}


def _tree_map(fn, tree, path=()):
    """Map fn(path, leaf) over a dict/tuple tree, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_map(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


class Model(nn.Module):
    """nn.Module holding a parameter tree (stacked ``[n_super, ...]`` pattern
    weights, reference layout) as buffers; ``tree()`` returns the tree with
    the module's own tensors, so ``.to(...)`` moves what the functions see."""

    def __init__(self, cfg: ArchConfig, params: Dict):
        super().__init__()
        self.cfg = cfg

        def register(path, leaf):
            name = "__".join(path)
            self.register_buffer(name, leaf)
            return name
        self._names = _tree_map(register, params)

    def tree(self) -> Dict:
        return _tree_map(lambda path, name: getattr(self, name), self._names)

    def forward(self, tokens, *, schedule: str = "diagonal", fused: bool = True,
                mode: str = "segmented"):
        return forward_hidden(self.tree(), self.cfg, tokens, schedule=schedule,
                              fused=fused, mode=mode)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed_rows(params: Dict, ids: torch.Tensor) -> torch.Tensor:
    """The embedding's rows ``ids`` -> [..., D]; inside a tensor-parallel
    context (``parallel/comm.py``) from this rank's block of the table."""
    tp = comm.current()
    return params["embed"][ids] if tp is None else tp.embed(params["embed"], ids)


def _first_stage() -> bool:
    sp = comm.current_stage()
    return sp is None or sp.index == 0


def _placeholder(params: Dict, shape) -> torch.Tensor:
    """The stack's input as a later stage sees it: the shape, dtype and
    device of the first stage's (the executors' hand-off template), one
    element of storage; never read."""
    return params["embed"].new_zeros(()).expand(shape)


def embed_segments(params: Dict, cfg: ArchConfig, tokens: torch.Tensor,
                   seg_len: int, with_mem: bool = True) -> torch.Tensor:
    """tokens: [B, S*seg_len] -> [S, B, seg_len (+ M), D]: with_mem appends
    the memory tokens to every segment, so with segment-local positions they
    sit at seg_len..seg_len+M-1. A model with learned positions (whisper)
    adds rows 0..seg_len+M-1 of its table to every segment, the memory
    rows included. On a later stage of a stage mesh, a placeholder of that
    shape (``_placeholder``)."""
    B, total = tokens.shape
    if total % seg_len:
        raise ValueError(f"{total} tokens do not split into segments of {seg_len}")
    S = total // seg_len
    M = params["mem_tokens"].shape[0] if with_mem and "mem_tokens" in params else 0
    if not _first_stage():
        return _placeholder(params, (S, B, seg_len + M, params["embed"].shape[1]))
    x = embed_rows(params, tokens.reshape(B, S, seg_len).transpose(0, 1))
    if with_mem and "mem_tokens" in params:
        M, D = params["mem_tokens"].shape
        x = torch.cat([x, params["mem_tokens"].expand(S, B, M, D)], dim=2)
    if "pos_embed" in params:
        x = x + params["pos_embed"][:x.shape[2]]
    return x


def encode(params: Dict, cfg: ArchConfig, frames: torch.Tensor, *,
           fused: bool = True) -> torch.Tensor:
    """Whisper's encoder: frame embeddings [B, F, D] (the frontend is a
    stub) plus the learned frame positions, the ``enc`` layers in order,
    then the final norm -> [B, F, D]. fused: each layer as the ``enc``
    cell at G = 1 (the biased projections and the GELU on the GEMM's
    epilogue, the attention one flash launch without a mask); False: the
    plain block (sdpa), the oracle."""
    enc = params["enc"]
    x = frames.to(enc["pos"].dtype) + enc["pos"][:frames.shape[1]]
    apply = (_one_layer_cell(make_grouped_apply(cfg, "full")) if fused
             else make_apply_block(cfg, "full"))
    for j in range(cfg.encoder.n_layers):
        x, _ = apply("enc", layer_slice(enc["blocks"], j), x, {})
    return norm(cfg.norm, x, enc["final_norm"])


def cross_kv_state(params: Dict, cfg: ArchConfig, enc_out: torch.Tensor, *,
                   fused: bool = True) -> Dict:
    """Every dec layer's cross K/V from the encoder's output [B, F, D] as new
    tensors: {"pattern": per position {"ck", "cv"} [n_super, B, F, Hkv,
    hd] (empty for the other positions)}, what ``init_state(cross_from=)``
    takes. Out of place, so under gradients every segment's
    cross-attention reaches the encoder. fused: two grouped-GEMM launches
    (K and V) over all the layers, the bias on the epilogue; False: the
    plain ``cross_kv`` a layer at a time, stacked."""
    layout = StackLayout.from_config(cfg)
    B, F, D = enc_out.shape
    L = layout.n_super
    pattern = []
    for p, t in enumerate(layout.pattern):
        if t != "dec":
            pattern.append({})
            continue
        px = params["pattern"][p]["xattn"]
        if fused:
            x = enc_out.reshape(1, B * F, D).expand(L, B * F, D).contiguous()
            ck, cv = (kops.grouped_gemm(x, px[w], px.get(b)).reshape(
                L, B, F, cfg.n_kv_heads, cfg.head_dim) for w, b in (("wk", "bk"), ("wv", "bv")))
        else:
            ck, cv = (torch.stack(kv) for kv in zip(*(
                cross_kv(enc_out, {k: v[j] for k, v in px.items()}, cfg) for j in range(L))))
        pattern.append({"ck": ck, "cv": cv})
    return {"pattern": tuple(pattern)}


def fill_cross_kv_(params: Dict, cfg: ArchConfig, state: Dict, enc_out: torch.Tensor, *,
                   fused: bool = True) -> None:
    """``cross_kv_state``'s cross K/V copied into ``state``'s ``ck``/``cv``
    [n_super, B, F, Hkv, hd] in place (a decode state, whose buffers the
    serve engine keeps)."""
    cross = cross_kv_state(params, cfg, enc_out, fused=fused)
    for st, kv in zip(state["pattern"], cross["pattern"]):
        for k, v in kv.items():
            st[k].copy_(v)


def segment_len(cfg: ArchConfig) -> int:
    """Tokens per segment: the ARMT segment, else ``DEFAULT_SEG_LEN``."""
    return cfg.armt.segment_len if cfg.armt is not None else DEFAULT_SEG_LEN


def forward_hidden(params: Dict, cfg: ArchConfig, tokens: torch.Tensor, *,
                   schedule: str = "diagonal", fused: bool = True,
                   mode: str = "segmented", state0: Optional[Dict] = None,
                   seg_len: Optional[int] = None, eager: bool = False,
                   capture_states: bool = False,
                   enc_frames: Optional[torch.Tensor] = None):
    """tokens: [B, S*seg_len] -> (hidden [S, B, seg_len, D] with the
    memory-token rows stripped, final executor state); with capture_states
    a third output, the recurrent state at every segment boundary (leaves
    with a leading [S] axis, boundary c at index c - 1): what the serving
    prefix cache stores (``serve/state_store.py``).

    mode 'segmented' runs the model's segments with ARMT memory; 'full'
    (the paper's full-attention baseline) runs one segment of the whole
    input with no memory tokens and no memory.

    schedule 'diagonal' runs ``run_diagonal``, 'sequential' runs
    ``run_sequential``, 'auto' the diagonal one when the segments are at
    least the layers, else the sequential one (the reference's choice).
    fused: both executors apply the fused grouped cell (the kernels; the
    sequential one as a band of one layer); ``fused=False`` applies the
    plain block (the diagonal executor slot by slot). state0 (the
    reference's ``init_state``): the executor state to start from, e.g. a
    final state of an earlier call; zero memory when None. seg_len: tokens
    per segment (default ``segment_len(cfg)``), cut to the whole input when
    shorter; full mode ignores it.

    An encoder-decoder (whisper) needs the encoder's cross K/V: either
    ``enc_frames`` [B, F, D] (frame embeddings; encoded, on the kernels
    when fused, and their cross K/V built out of place by
    ``cross_kv_state``, so under gradients every segment's cross-attention
    reaches the encoder), or a state0 that holds them (e.g. a decode
    state's, shared through ``init_state(..., cross_from=)``), not both.
    The executors read ck/cv and never copy them.

    On a CUDA device the sequential schedule on the fused cell in segmented
    mode replays one captured CUDA graph per segment (``SegmentProgram``,
    captured once per shape and weights; a capture copies its static state
    out after each replay); ``eager=True`` runs ``run_sequential`` instead,
    for comparisons, as the CPU always does. Every other path runs
    eagerly.

    Under gradients (grad mode on and a layer weight that requires one:
    ``lm_loss``, training) both executors take their out-of-place forms,
    never the captured program, with each cell rematerialized unless
    ``cfg.remat == "none"``; the forward gives the same bits. A capture is
    forward-only."""
    check_mode(mode)
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; expected one of {SCHEDULES}")
    if mode == "full":
        seg_len, with_mem = tokens.shape[1], False
    else:
        seg_len, with_mem = min(seg_len or segment_len(cfg), tokens.shape[1]), True
    x = embed_segments(params, cfg, tokens, seg_len, with_mem)
    layout = StackLayout.from_config(cfg)
    if schedule == "auto":
        schedule = "diagonal" if x.shape[0] >= grid(layout)[0] else "sequential"
    if cfg.encoder is None and enc_frames is not None:
        raise ValueError(f"{cfg.name} has no encoder: enc_frames is for whisper")
    if cfg.encoder is not None and (state0 is None) == (enc_frames is None):
        raise ValueError(f"{cfg.name}: pass enc_frames (the stub frontend's frame "
                         "embeddings) or a state0 holding the cross K/V, one of the two")
    if state0 is None:
        cross = (None if enc_frames is None else cross_kv_state(
            params, cfg, encode(params, cfg, enc_frames, fused=fused), fused=fused))
        state0 = init_state(cfg, tokens.shape[0], tokens.device, params["embed"].dtype,
                            mode, cross_from=cross)
    apply = make_apply_block(cfg, mode)
    grouped = make_grouped_apply(cfg, mode) if fused else None
    exec_params = {"prelude": params["prelude"], "pattern": params["pattern"]}
    grad_on = training(params, x)
    remat = grad_on and cfg.remat != "none"
    if schedule == "diagonal":
        out = run_diagonal(layout, exec_params, state0, x, apply, grouped_apply=grouped,
                           capture_states=capture_states, remat=remat)
        if capture_states:      # per step -> per boundary; the step capture goes
            out = out[:2] + (boundary_states_from_capture(layout, out[2], x.shape[0]),)
    elif (fused and mode == "segmented" and x.device.type == "cuda" and not eager
          and not grad_on):
        out = SegmentProgram.get(params, cfg, x.shape[1:]).run(x, state0,
                                                               capture_states=capture_states)
    else:
        out = run_sequential(layout, exec_params, state0, x,
                             _one_layer_cell(grouped) if fused else apply,
                             capture_states=capture_states, remat=remat)
    return (out[0][:, :, :seg_len],) + tuple(out[1:])


class SegmentProgram:
    """The sequential schedule's segment body as a captured program: the
    fused cell of every layer, in order, over one segment, from a static
    input segment ``x`` [B, T, D] into the graph's output, with the layers'
    state (A, z; or h and the conv tail) in static buffers updated in
    place. ``run`` replays it once per segment. capture=False runs the
    same body uncaptured (its CPU tests).

    ``get`` keeps the last few captured programs, keyed by the segment's
    shape and dtype and by the address, shape and strides of every layer
    weight (the graph reads them where they were at capture; the TMA
    descriptors of the kernels hold their addresses)."""

    CACHED = 4
    _cache: "OrderedDict" = OrderedDict()

    def __init__(self, params: Dict, cfg: ArchConfig, shape, dtype, device, *,
                 capture: bool = True):
        B, T, D = shape
        layout = StackLayout.from_config(cfg)
        self.x = torch.zeros(B, T, D, dtype=dtype, device=device)
        self.state = init_state(cfg, B, device, params["embed"].dtype)
        exec_params = {"prelude": params["prelude"], "pattern": params["pattern"]}
        cell = _one_layer_cell(make_grouped_apply(cfg))
        x, state = self.x, self.state

        def body():
            return run_sequential_(layout, exec_params, state, x[None], cell)[0]
        self.program = Program(body, device, capture=capture)

    @classmethod
    def get(cls, params: Dict, cfg: ArchConfig, shape) -> "SegmentProgram":
        dtype, device = params["embed"].dtype, params["embed"].device
        leaves = []
        _tree_map(lambda path, t: leaves.append((t.data_ptr(), tuple(t.shape),
                                                 t.stride(), t.dtype)),
                  (params["prelude"], params["pattern"]))
        key = (cfg, tuple(shape), dtype, device, tuple(leaves))
        if key in cls._cache:
            cls._cache.move_to_end(key)
        else:
            cls._cache[key] = cls(params, cfg, shape, dtype, device)
            while len(cls._cache) > cls.CACHED:
                cls._cache.popitem(last=False)
        return cls._cache[key]

    def run(self, segments: torch.Tensor, state0: Dict, *, capture_states: bool = False):
        """segments [S, B, T, D] from state0 -> (ys [S, B, T, D], a copy of
        the final state); capture_states: also, third, the recurrent state
        after every segment, copied out of the static state after each
        replay (leading [S])."""
        copy_state_(self.state, state0)
        ys = torch.empty_like(segments)
        cap = capture_init(self.state, segments.shape[0]) if capture_states else None
        for s in range(segments.shape[0]):
            self.x.copy_(segments[s])
            ys[s].copy_(self.program())
            if cap is not None:
                capture_write_(cap, self.state, s)
        # the recurrent leaves copied out; the constant ones (a dec layer's
        # ck/cv) are state0's
        fin = {part: tuple({k: v.clone() if k in RECURRENT_KEYS else s0[k]
                            for k, v in st.items()}
                           for st, s0 in zip(self.state[part], state0[part]))
               for part in ("prelude", "pattern")}
        return (ys, fin, cap) if capture_states else (ys, fin)


def copy_state_(dst: Dict, src: Dict) -> None:
    """dst's layer leaves <- src's, in place (by key; src's dtype cast)."""
    for part in ("prelude", "pattern"):
        for d, s in zip(dst[part], src[part]):
            for k, leaf in d.items():
                leaf.copy_(s[k])


def _head_matmul(params: Dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """h [..., D] -> logits [..., V]: the tied embedding's transpose or the
    head; inside a tensor-parallel context from this rank's block, the
    local logits all-gathered (a vocab split) or the partial products
    all-reduced (a d split)."""
    tp = comm.current()
    w = params["embed"].t() if cfg.tie_embeddings else params["head"]
    if tp is None:
        return torch.matmul(h, w)
    return tp.logits(h, w, tp.embed_split if cfg.tie_embeddings else tp.head_split)


CE_CHUNK = 256   # tokens of a segment whose fp32 logits lm_loss makes at once


def _chunk_nll(params: Dict, cfg: ArchConfig, h: torch.Tensor, y: torch.Tensor,
               m: torch.Tensor) -> torch.Tensor:
    """Masked NLL sum of one chunk: h [B, Tc, D], labels y and mask m [B,
    Tc]; fp32 logits of the final norm and the head."""
    logits = _head_matmul(params, cfg, norm(cfg.norm, h, params["final_norm"])).float()
    gold = torch.gather(logits, -1, y[..., None])[..., 0]
    return ((torch.logsumexp(logits, dim=-1) - gold) * m).sum()


def lm_loss(params: Dict, cfg: ArchConfig, tokens: torch.Tensor, labels: torch.Tensor, *,
            schedule: str = "diagonal", mode: str = "segmented",
            seg_len: Optional[int] = None, loss_mask: Optional[torch.Tensor] = None,
            fused: bool = True, enc_frames: Optional[torch.Tensor] = None,
            mesh=None) -> torch.Tensor:
    """Mean next-token NLL (a 0-d fp32 tensor) of tokens/labels [B, S*seg_len]
    through ``forward_hidden`` (with gradients on, its out-of-place
    executors; never the captured ``SegmentProgram``), loss_mask [B, ...]
    weighting each position (None: all 1). The logits are never made for
    the whole sequence: per segment, chunks of ``CE_CHUNK`` tokens where
    they divide it (else the segment whole), in the reference's order
    (segment major), each chunk's fp32 logits [B, chunk, V] recomputed in
    the backward (``torch.utils.checkpoint``) rather than kept.

    mesh: the rows are this rank's share of a batch over the mesh's DP
    axes (its block of rows, or all of them where the batch does not
    split, ``data/loader.py`` ``shard_batch``): the NLL sum is divided by
    the mask count summed over those axes, so that the sum of the ranks'
    losses (and gradients) over them is the whole batch's mean, rows a
    rank holds in replica counted once."""
    hidden, _ = forward_hidden(params, cfg, tokens, schedule=schedule, fused=fused,
                               mode=mode, seg_len=seg_len, enc_frames=enc_frames)
    S, B, T, _ = hidden.shape
    labels = labels.long().reshape(B, S, T)
    mask = (torch.ones(B, S, T, dtype=torch.float32, device=hidden.device)
            if loss_mask is None else loss_mask.reshape(B, S, T).float())
    n_chunks = T // CE_CHUNK if (T % CE_CHUNK == 0 and T > CE_CHUNK) else 1
    Tc = T // n_chunks
    keep = torch.is_grad_enabled() and hidden.requires_grad
    total = hidden.new_zeros((), dtype=torch.float32)
    for s in range(S):
        for c in range(0, T, Tc):
            args = (params, cfg, hidden[s, :, c:c + Tc], labels[:, s, c:c + Tc],
                    mask[:, s, c:c + Tc])
            total = total + (checkpoint(_chunk_nll, *args, use_reentrant=False,
                                        preserve_rng_state=False) if keep
                             else _chunk_nll(*args))
    count = mask.sum()
    if mesh is not None:
        from repro_torch.parallel.sharding import dp_axes
        count = comm.all_reduce(count, mesh, dp_axes(mesh))
    return total / count.clamp_min(1.0)


def last_logits(params: Dict, cfg: ArchConfig, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits of the final position of the final segment [B, V]."""
    h = norm(cfg.norm, hidden[-1, :, -1], params["final_norm"])
    return _head_matmul(params, cfg, h).float()


def boundary_logits(params: Dict, cfg: ArchConfig, hidden: torch.Tensor) -> torch.Tensor:
    """fp32 logits of the last position of every segment: hidden [S, B, T,
    D] -> [S, B, V] (what a segment-boundary snapshot keeps beside its
    state)."""
    h = norm(cfg.norm, hidden[:, :, -1], params["final_norm"])
    return _head_matmul(params, cfg, h).float()


# ---------------------------------------------------------------------------
# Decode / serving ('armt': memory + current-segment cache; 'cache': full KV)
# ---------------------------------------------------------------------------

def check_serve_mode(serve_mode: str) -> None:
    if serve_mode not in SERVE_MODES:
        raise ValueError(f"unknown serve_mode {serve_mode!r}; expected one of "
                         f"{SERVE_MODES}")


def decode_state_init(cfg: ArchConfig, batch: int, *, dtype, device,
                      serve_mode: str = "armt", max_len: Optional[int] = None,
                      per_slot_pos: bool = False) -> Dict:
    """Per-layer decode state. serve_mode 'armt': for attn, A/z (fp32) and
    a current-segment KV cache of seg_len + M rows (``max_len`` rows for a
    model without ARMT); 'cache': for attn, a full KV cache of ``max_len``
    rows and no A/z. For mamba either way h (fp32) and the conv tail
    (``dtype``), no cache. A dec layer also holds its cross K/V ``ck``/``cv``
    (zeros: ``fill_cross_kv_`` writes them from the encoder). ``pos`` (the
    in-segment position, or in cache mode the tokens in the cache; the
    learned positions' row too) is a Python int, or an int64 [batch]
    tensor with per_slot_pos."""
    check_serve_mode(serve_mode)
    layout = StackLayout.from_config(cfg)
    a = cfg.armt if serve_mode == "armt" else None
    if a is None and max_len is None and set(layout.layer_types) & set(ATTN_TYPES):
        raise ValueError(f"decode_state_init(serve_mode={serve_mode!r}) of "
                         f"{cfg.name} needs max_len for its KV cache")
    state = init_state(cfg, batch, device, dtype,
                       "segmented" if serve_mode == "armt" else "full")
    rows = a.segment_len + a.num_mem_tokens if a is not None else max_len
    for lead, types, part in (((), layout.prelude, "prelude"),
                              ((layout.n_super,), layout.pattern, "pattern")):
        for t, st in zip(types, state[part]):
            if t in ATTN_TYPES:
                cache = lead + (batch, rows, cfg.n_kv_heads, cfg.head_dim)
                st["k"] = torch.zeros(cache, dtype=dtype, device=device)
                st["v"] = torch.zeros(cache, dtype=dtype, device=device)
    state["pos"] = (torch.zeros(batch, dtype=torch.long, device=device)
                    if per_slot_pos else 0)
    return state


def decode_state_shapes(cfg: ArchConfig, batch: int, *, serve_mode: str, max_len: int,
                        dtype, per_slot_pos: bool = False) -> Dict:
    """A decode state's shapes and dtypes without allocation:
    ``decode_state_init`` on the meta device (``pos`` a host int, or an
    int64 [batch] meta tensor with per_slot_pos)."""
    return decode_state_init(cfg, batch, dtype=dtype, device="meta", serve_mode=serve_mode,
                             max_len=max_len, per_slot_pos=per_slot_pos)


def decode_state_sharding(cfg: ArchConfig, mesh, batch: int, *, serve_mode: str,
                          max_len: int, dtype, per_slot_pos: bool = False,
                          stacked_axis: Optional[str] = None) -> Dict:
    """``Sharding`` tree of a decode state on ``mesh``: slots (the batch)
    over the DP axes, heads and the memory's value dim over 'model',
    pattern-stacked leaves optionally over ``stacked_axis``: the placement
    the mesh engine derives its pools, transplants and restores from."""
    from repro_torch.parallel import sharding as shd
    shapes = decode_state_shapes(cfg, batch, serve_mode=serve_mode, max_len=max_len,
                                 dtype=dtype, per_slot_pos=per_slot_pos)
    return shd.decode_state_specs(shapes, mesh, batch, stacked_axis=stacked_axis)


# ---------------------------------------------------------------------------
# Tensor parallelism: the local view of a model on a mesh's 'model' axis
# ---------------------------------------------------------------------------

MESH_TYPES = ("attn",)      # the block types the tensor-parallel cells run


def mesh_family(cfg: ArchConfig) -> bool:
    """Whether cfg is of the dense ARMT family, the configs that serve and
    train on a mesh: ``MESH_TYPES`` layers only, no prelude, MoE, SSM or
    encoder (the others wait in ROADMAP Queue 1 item 8)."""
    return (set(cfg.layer_types) <= set(MESH_TYPES) and not cfg.prelude
            and cfg.moe is None and cfg.ssm is None and cfg.encoder is None)


def local_config(cfg: ArchConfig, tp: int, stages: int = 1) -> ArchConfig:
    """The config of what one rank computes, of ``tp`` ranks of the 'model'
    axis and ``stages`` of the 'stage' axis: the q and kv heads and d_ff
    divided by tp, and the ARMT value dim too where tp divides it (the
    rules split ``wv`` and A there, else keep them whole); the layers
    divided by stages (a block of consecutive layers; ``shard_model``
    passes stages > 1 only where they divide the layers, else every stage
    runs the whole stack). cfg itself at tp = stages = 1. A dim tp does
    not divide is refused with the dim named: the cells split whole heads
    (the reference's GSPMD may cut a head, or a cache's sequence, which
    explicit cells cannot)."""
    if stages > 1:
        if cfg.n_layers % stages:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split into "
                             f"{stages} stage blocks")
        cfg = replace(cfg, n_layers=cfg.n_layers // stages)
    if tp == 1:
        return cfg
    for name, n in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                    ("d_ff", cfg.d_ff)):
        if n % tp:
            raise ValueError(f"{cfg.name}: {name} {n} does not divide over the mesh's "
                             f"model axis of {tp}")
    armt = cfg.armt
    if armt is not None:
        dv = armt.d_val or cfg.d_model
        if dv % tp == 0:
            armt = replace(armt, d_val=dv // tp)
    return replace(cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                   d_head=cfg.head_dim, d_ff=cfg.d_ff // tp, armt=armt)


def shard_model(params: Dict, cfg: ArchConfig, mesh):
    """The local view of a model on ``mesh``: (this rank's params, the local
    config, the ``comm.TensorParallel`` the cells run under, None without a
    'model' axis of more than one rank, and the ``comm.StageParallel`` the
    executors run under, None without a 'stage' axis of more than one rank
    that divides the layers). The params are every leaf's block under
    ``sharding.param_specs(stacked_axis="stage")`` (a view of the leaf
    where the block is contiguous in it: a replicated leaf, a block of
    rows; else a copy): the pattern leaves' [n_super, ...] dim cut to the
    rank's block of layers; embed, final_norm and head whole (over
    'model' as the rules say). The QKV biases, which the rules replicate,
    are cut to the rank's own columns. Where 'stage' does not divide the
    layers the slot buffer's rule falls back to replication (its warning
    and ``sharding_fallback_total{kind="slot_buf"}``) and every stage rank
    runs the whole stack, as the reference replicates."""
    from repro_torch.parallel import sharding as shd
    tp = shd.tp_size(mesh)
    stacked = "stage" if "stage" in mesh.axis_names else None
    sp = None
    if stacked:
        spec = shd.slot_buf_spec(mesh, cfg.n_layers, 1)
        if spec is not None and spec[0] == "stage" and shd.stage_size(mesh) > 1:
            sp = comm.StageParallel(mesh, cfg.n_layers)
    lcfg = local_config(cfg, tp, 1 if sp is None else sp.size)
    specs = local_param_specs(params, mesh, stacked_axis=stacked)
    local = comm.shard_tree(params, specs, mesh, copy=False)
    return local, lcfg, tensor_parallel(specs, mesh), sp


def local_param_specs(params: Dict, mesh, *, stacked_axis: Optional[str] = None) -> Dict:
    """The ``Sharding`` tree of a rank's local view of the params (a tree of
    tensors or of their shapes): ``sharding.param_specs``, with the QKV
    biases, which the rules replicate, cut to the rank's columns over
    'model' as the tensor-parallel cells read them. ``shard_model`` cuts
    by it, the mesh train step's state and checkpoints by it."""
    from repro_torch.parallel import sharding as shd
    specs = shd.param_specs(params, mesh, stacked_axis=stacked_axis)
    if shd.tp_size(mesh) == 1:
        return specs
    for blk in specs["prelude"] + specs["pattern"]:
        for name in ("attn", "xattn"):
            for b in ("bq", "bk", "bv"):
                if name in blk and b in blk[name]:
                    blk[name][b] = shd.Sharding(mesh, shd.P(*blk[name][b].spec[:-1], "model"))
    return specs


def tensor_parallel(specs: Dict, mesh) -> Optional[comm.TensorParallel]:
    """The tensor-parallel context of the cells on ``mesh`` from the params'
    ``Sharding`` tree (how the embedding and the head are split); None
    without a 'model' axis of more than one rank."""
    from repro_torch.parallel import sharding as shd
    if shd.tp_size(mesh) == 1:
        return None
    embed = specs["embed"].spec                                      # [V, D]
    head = specs["head"].spec if "head" in specs else (None, None)   # [D, V]
    embed_split = "vocab" if embed[0] else "d" if embed[1] else None
    head_split = "vocab" if head[1] else "d" if head[0] else None
    return comm.TensorParallel(mesh, embed_split, head_split)


def make_decode_apply(cfg: ArchConfig, serve_mode: str, pos, mask=None):
    """Block apply for decode: x [B, Tq, D] against the layer's cache
    (attn, attn_moe and dec; with the memory read in 'armt' mode), which it
    updates in place (with mask, bool [B], only the True rows), or its
    carried SSM state (mamba and mamba_moe: the new h and conv tail are
    returned for the executor to write), then, in a dec layer, the
    cross-attention to its ck/cv on the kernels (``decode_cross_attention``),
    then the layer's FFN, never blockwise (as the reference's decode). A
    MoE layer dispatches all B * Tq tokens, the rows the mask freezes
    included, as the reference does."""
    check_serve_mode(serve_mode)
    armt_on = serve_mode == "armt" and cfg.armt is not None

    def apply(t, p, x, st):
        if t in MAMBA_TYPES:
            h, new = mamba_block(p, x, cfg.ssm, st)
            return apply_ffn(cfg, t, h, p), new
        if t not in ATTN_TYPES:
            raise ValueError(t)
        if armt_on:
            x = x + comm.tp_gather(mem_read(p["mem"], st, x, cfg.armt))
        h = x + comm.tp_reduce(decode_attention(norm(cfg.norm, x, p["ln1"]), p["attn"], cfg,
                                                {"k": st["k"], "v": st["v"]}, pos, mask))
        if t == "dec":
            h = h + decode_cross_attention(norm(cfg.norm, h, p["ln_x"]), p["xattn"],
                                           st["ck"], st["cv"], cfg)
        return apply_ffn(cfg, t, h, p), st
    return apply


def _with_positions(params: Dict, x: torch.Tensor, pos) -> torch.Tensor:
    """x [B, Tq, D] plus rows pos..pos+Tq-1 of the learned position table,
    where the model has one (whisper); pos a host int or per-row [B]. The
    first row is clamped to [0, max_position - Tq], as the reference's
    dynamic slice clamps."""
    if "pos_embed" not in params:
        return x
    table = params["pos_embed"]
    Tq, top = x.shape[1], params["pos_embed"].shape[0] - x.shape[1]
    if not isinstance(pos, torch.Tensor):
        start = min(max(pos, 0), top)
        return x + table[start:start + Tq]
    rows = pos.clamp(0, top)[:, None] + torch.arange(Tq, device=x.device)[None]
    return x + table[rows]


def _exec(params, state):
    return ({"prelude": params["prelude"], "pattern": params["pattern"]},
            {"prelude": state["prelude"], "pattern": state["pattern"]})


def _check_mask(state: Dict, mask, what: str) -> None:
    if mask is not None and not isinstance(state["pos"], torch.Tensor):
        raise ValueError(f"{what} needs a per-slot pos vector "
                         "(decode_state_init(per_slot_pos=True)); a scalar pos "
                         "cannot be masked per row")


def decode_step_(params: Dict, cfg: ArchConfig, state: Dict, tokens: torch.Tensor, *,
                 serve_mode: str = "armt", mask: Optional[torch.Tensor] = None):
    """In place (the port of the reference's donated state): tokens [B]
    (one step) or [B, Tq] (a chunk) -> fp32 logits of the last position [B,
    V]; the new k/v rows are written into the caches, each layer's new
    recurrent leaves into the stacked state, and pos advances by Tq (a
    per-slot tensor on the device; a Python int is replaced). mask: bool
    [B] (per-slot pos only): rows where it is False keep every leaf and pos
    bit for bit, their logits to be discarded. serve_mode must be the one
    the state was made for. On a stage mesh, the rank's block of the layers
    (``run_sequential_``), the last stage's output broadcast to every rank
    before the final norm and the head."""
    _check_mask(state, mask, "decode_step_(mask=...)")
    layout = StackLayout.from_config(cfg)
    pos = state["pos"]
    toks = tokens if tokens.dim() == 2 else tokens[:, None]
    x = (_with_positions(params, embed_rows(params, toks), pos) if _first_stage() else
         _placeholder(params, tuple(toks.shape) + (params["embed"].shape[1],)))
    exec_params, exec_state = _exec(params, state)
    ys = run_sequential_(layout, exec_params, exec_state, x[None],
                         make_decode_apply(cfg, serve_mode, pos, mask), row_mask=mask)
    h = norm(cfg.norm, comm.stage_last(ys[0])[:, -1], params["final_norm"])
    Tq = toks.shape[1]
    if not isinstance(pos, torch.Tensor):
        state["pos"] = pos + Tq
    elif mask is None:
        pos.add_(Tq)
    else:
        pos.add_(mask.long() * Tq)
    return _head_matmul(params, cfg, h).float()


def decode_step(params: Dict, cfg: ArchConfig, state: Dict, tokens: torch.Tensor, *,
                serve_mode: str = "armt"):
    """Functional ``decode_step_``: (logits [B, V], new state); ``state`` is
    not modified."""
    new = clone_state(state)
    return decode_step_(params, cfg, new, tokens, serve_mode=serve_mode), new


def mask_decode_state(mask: torch.Tensor, new_state: Dict, old_state: Dict) -> Dict:
    """Per-row merge of two decode states: rows where ``mask`` (bool [B]) is
    True take ``new_state``, the others keep ``old_state``. Pattern leaves
    are [n_super, B, ...]; a per-slot ``pos`` is [B]. (The serving path
    freezes rows in place instead: ``decode_step_(mask=)``.)"""
    def sel(n, o, axis):
        shape = [1] * n.dim()
        shape[axis] = mask.shape[0]
        return torch.where(mask.reshape(shape), n, o)

    out = {
        "prelude": tuple({k: sel(n[k], o[k], 0) for k in n}
                         for n, o in zip(new_state["prelude"], old_state["prelude"])),
        "pattern": tuple({k: sel(n[k], o[k], 1) for k in n}
                         for n, o in zip(new_state["pattern"], old_state["pattern"])),
    }
    npos, opos = new_state["pos"], old_state["pos"]
    if isinstance(npos, torch.Tensor):
        out["pos"] = torch.where(mask, npos, opos)
    else:   # a scalar pos is merged only if the whole mask agrees
        out["pos"] = npos if bool(mask.all()) else opos
    return out


def flush_segment_(params: Dict, cfg: ArchConfig, state: Dict,
                   mask: Optional[torch.Tensor] = None) -> None:
    """ARMT segment boundary, in place: run the memory tokens through the
    stack against the current-segment cache (at positions pos..pos+M-1),
    delta-update every attn layer's (A, z), then zero its cache; reset pos.
    In a hybrid stack (jamba) the memory tokens also pass through the Mamba
    layers, whose scan over the M tokens advances their h and conv tail, as
    the reference's flush does.

    mask: optional bool [B] (per-slot pos only): flush only those rows; the
    others keep every leaf and pos bit for bit. On a stage mesh each rank
    flushes its block of the layers, the memory tokens' activations handed
    from stage to stage (``run_sequential_``)."""
    if cfg.armt is None:
        raise ValueError(f"{cfg.name}: flush_segment needs cfg.armt; a model "
                         "without ARMT has no segment boundary to flush")
    _check_mask(state, mask, "flush_segment(slot_mask=...)")
    layout = StackLayout.from_config(cfg)
    mem = params["mem_tokens"]
    batch = next(iter(state["pattern"][0].values())).shape[1]
    x = (_with_positions(params, mem[None].expand(batch, -1, -1), state["pos"])
         if _first_stage() else _placeholder(params, (batch,) + tuple(mem.shape)))
    base = make_decode_apply(cfg, "armt", state["pos"], mask)
    drop = None if mask is None else mask.reshape(-1, 1, 1, 1)

    def apply(t, p, xx, st):
        y, new = base(t, p, xx, st)
        if t in MAMBA_TYPES:
            return y, new
        new = dict(new, **mem_update(p["mem"], {"A": st["A"], "z": st["z"]}, y, cfg.armt))
        for k in ("k", "v"):
            if drop is None:
                st[k].zero_()
            else:
                st[k].masked_fill_(drop, 0)
        return y, new

    exec_params, exec_state = _exec(params, state)
    run_sequential_(layout, exec_params, exec_state, x[None], apply, row_mask=mask)
    pos = state["pos"]
    if not isinstance(pos, torch.Tensor):
        state["pos"] = 0
    elif mask is None:
        pos.zero_()
    else:
        pos.masked_fill_(mask, 0)


def flush_segment(params: Dict, cfg: ArchConfig, state: Dict,
                  slot_mask: Optional[torch.Tensor] = None) -> Dict:
    """Functional ``flush_segment_``: the flushed state; ``state`` is not
    modified. slot_mask: optional bool [B]: flush only those rows (decode
    slots); it needs a per-slot ``pos`` vector."""
    new = clone_state(state)
    flush_segment_(params, cfg, new, slot_mask)
    return new
