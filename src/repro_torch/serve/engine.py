"""Serving engine: prefill, then decode (greedy, or sampled on the device);
``serve`` is the continuous-batching front door over many requests
(``serve/scheduler.py``).

``generate(prompts [B, P], max_new, temperature=, top_k=, seed=)`` with
``serve_mode="armt"`` (constant-memory serving, the paper's Fig. 1):
  1. the prompt's full pieces of ``seg_len`` tokens run through
     ``forward_hidden`` under the engine's schedule (diagonal or
     sequential) on the fused grouped cell (the kernels), in the model's
     segments;
  2. the final recurrent state (A, z; or h and the conv tail) moves into a
     fresh decode state (``_transplant``) and the prompt tail is fed through
     ``decode_step``, flushing at an ARMT segment boundary;
  3. decode: one step per token (for ARMT models its attention on the
     decode-attention kernel, with a segment flush when the in-segment
     position reaches seg_len; for Mamba models the scan on the mamba_scan
     kernel), run by a ``DecodeProgram``.

With ``serve_mode="cache"`` (standard full-KV decoding, the paper's
baseline) the whole prompt is one ``decode_step`` chunk from position 0
into a KV cache of ``max_len`` rows (its attention on the flash kernel),
and every decoded token attends the whole cache prefix; nothing flushes.

An ARMT model's seg_len is its segment. A pure-SSM model (falcon-mamba) has
no segment boundary: its seg_len is ``max_len``, the largest piece of a
prompt that goes through the diagonal prefill at once, which runs it in
segments of ``DEFAULT_SEG_LEN`` tokens; it never flushes.

Decode runs over static state updated in place (the port of the
reference's donated, jitted loop): a ``DecodeProgram`` holds a decode
state of B rows whose ``pos`` is an int64 [B] tensor on the device, and the
step (decode, sampling, the finite flag) and the flush as ``Program``s. On
the card each is a CUDA graph, captured at first use and replayed per
token; ``ServeEngine(eager=True)`` runs the same programs uncaptured, for
comparisons only, and the CPU always does. The step reads its position
from the device; the host keeps a mirror of it (every step advances it by
one) to decide where to replay the flush. The prompt tail runs eagerly
before decode, with its position a host int (a chunk at position 0 goes
to the flash kernel on the card).

Sampling (``sample``) runs on the device: temperature-scaled logits, those
below the k-th largest masked when ``top_k > 0``, one Gumbel-max draw from
a ``torch.Generator`` on the engine's device seeded from ``seed``; the
tokens come to the host once, at the end.

The prefill is also a resumable pipeline (``start_prefill`` ->
``PrefillPipeline``): the blocking prefill's work cut into bounded units,
each ``advance()`` running one of them: ``groups_per_call`` band steps of
the current diagonal stage (``core/diagonal.py`` ``pipeline_step``, the
one-shot executor's band step) or one tail piece (``_tail_pieces``, the
decomposition ``_chunk`` runs). ``serve``'s scheduler interleaves these
units with decode chunks, so a long admission no longer stalls every
decoding slot, and each admission's tokens are those of the blocking path
by construction. ``AdmissionPool`` advances several such admissions per
round, the diagonal stages of one signature through one pooled band step
(``pipeline_step_pool``). The band steps run eagerly.

The engine may carry the serving state stores (``serve/state_store.py``):
a ``PrefixCache`` (the longest cached prefix of a B = 1 prompt, at segment
granularity, is transplanted, and only the segments after it are
prefilled, with their boundary states captured and inserted) and a
``SessionStore`` (``generate(..., session_id=)`` and ``serve``'s requests
resume a conversation from its stored end state, feeding only the new
turn). Everything the stores keep, and everything taken from them, is a
copy: the engine's programs and executors update their state in place.

``telemetry`` (``serve/telemetry.py``): metrics into the process registry
by default, spans when a trace recorder is asked for; host-side only.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core import diagonal as diag
from repro_torch.core.capture import Program
from repro_torch.core.memory import RECURRENT_KEYS, recurrent_state
from repro_torch.core.schedule import StackLayout, n_diagonal_groups, pool_cells_remaining
from repro_torch.core.sequential import clone_state
from repro_torch.models.blocks import MAMBA_TYPES, block_d_ff, make_apply_block
from repro_torch.models.grouped_blocks import make_grouped_apply
from repro_torch.models.moe import capacity
from repro_torch.models.model import (SCHEDULES, boundary_logits, check_serve_mode,
                                      copy_state_, decode_state_init, decode_step_,
                                      embed_segments, encode, fill_cross_kv_,
                                      flush_segment_, forward_hidden, init_state,
                                      last_logits, resolve_device, segment_len)
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.serve.state_store import prefix_hash_chain, tree_nbytes
from repro_torch.serve.telemetry import Telemetry


def _transplant(fin: Dict, dstate: Dict) -> None:
    """Copy the recurrent leaves (A/z; h, conv) of an executor state into a
    decode state, in place; the decode state also holds the KV caches and
    pos."""
    for part in ("prelude", "pattern"):
        for src, dst in zip(fin[part], dstate[part]):
            for k in RECURRENT_KEYS:
                if k in src:
                    dst[k].copy_(src[k])


def _greedy(temperature: float, top_k: int) -> bool:
    return temperature <= 0.0 or top_k == 1


def _sampler(temperature: float, top_k: int):
    """The key of a sampler's step program: None for greedy."""
    return None if _greedy(temperature, top_k) else (temperature, top_k)


def sample(logits: torch.Tensor, *, temperature: float, top_k: int,
           generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next tokens [B] (int64) from fp32 logits [B, V], on their device.
    temperature <= 0 or top_k == 1: greedy (argmax, the first of tied
    maxima; generator unused). Otherwise a draw from softmax(logits /
    temperature), restricted to the top_k largest when top_k > 1 (ties with
    the k-th kept, as the reference's ``jax.lax.top_k`` mask), by the
    Gumbel-max trick: argmax of the scaled logits plus -log(-log u), u ~
    U[0, 1) from ``generator``, or ``noise`` ([B, V], such u drawn before,
    e.g. outside a CUDA graph).

    top_k == 1 is greedy by definition here: the reference's mask would keep
    every logit tied with the largest and draw among them, and bf16 logits
    over a 128k vocabulary do tie at the top."""
    if _greedy(temperature, top_k):
        return logits.argmax(-1)
    scaled = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(scaled, min(top_k, scaled.shape[-1]), dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    u = noise if noise is not None else torch.rand(scaled.shape, generator=generator,
                                                   device=scaled.device)
    return (scaled - torch.log(-torch.log(u))).argmax(-1)


@dataclass
class GenerationResult:
    tokens: np.ndarray          # [B, max_new]
    prefill_segments: int
    finite: bool = True         # every logit the tokens were taken from was finite
    ttft_s: float = 0.0         # prefill wall time, ending in a device sync
    tok_s: float = 0.0          # decode tokens (all rows) per second after the first
    capture_s: float = 0.0      # host time this call spent capturing graphs
    logits: Optional[torch.Tensor] = None   # keep=True: [B, max_new, V] fp32
    state: Optional[Dict] = None            # keep=True: a copy of the final state
    cached_segments: int = 0    # segments transplanted from the prefix cache
    session_id: Optional[str] = None
    resumed: bool = False       # restored from the session store
    metrics: Optional[Dict] = None          # the telemetry snapshot (None: metrics off)


class DecodeProgram:
    """Decode over ``batch`` rows as programs over static state, updated in
    place (``core/capture.py``): ``state`` (a decode state with a per-row
    ``pos`` tensor), ``tok`` (each row's next input, int64 [B]), ``active``
    (bool [B]: the rows a step advances; the others keep every leaf bit for
    bit), ``boundary`` (bool [B]: the rows a flush flushes) and ``finite``
    (bool [B]: every logit an active row's tokens came from was finite).

    ``step`` runs the decode step, draws the next tokens (greedy, or
    sampled with noise drawn outside the program into ``noise``) and
    updates ``finite``; ``flush`` the masked segment flush. On a CUDA
    device they are CUDA graphs unless the engine is eager, each captured
    when it is made: the flush with the DecodeProgram, the step of each
    sampler by ``prepare``, which must come before ``load`` or any other
    write of live data, since a capture's warm-up runs the program."""

    def __init__(self, engine: "ServeEngine", batch: int):
        dev = engine.device
        self.params, self.cfg, self.serve_mode = engine.params, engine.cfg, engine.serve_mode
        self.device, self.capture = dev, engine.capture
        self.state = engine.decode_state(batch, per_slot_pos=True)
        self.tok = torch.zeros(batch, dtype=torch.long, device=dev)
        self.active = torch.ones(batch, dtype=torch.bool, device=dev)
        self.boundary = torch.ones(batch, dtype=torch.bool, device=dev)
        self.finite = torch.ones(batch, dtype=torch.bool, device=dev)
        self.noise = None
        self._steps: Dict = {}
        self._flush = None
        if engine.flushes:
            params, cfg, state, boundary = self.params, self.cfg, self.state, self.boundary
            self._flush = Program(lambda: flush_segment_(params, cfg, state, mask=boundary),
                                  dev, capture=self.capture)

    def prepare(self, temperature: float = 0.0, top_k: int = 0) -> float:
        """Makes (captures) the step of this sampler, if not made yet;
        returns the host seconds that took (0 when it was made before)."""
        key = _sampler(temperature, top_k)
        if key in self._steps:
            return 0.0
        t0 = time.perf_counter()
        if key is not None and self.noise is None:
            self.noise = torch.rand(self.tok.shape[0], self.cfg.vocab, device=self.device)
        params, cfg, serve_mode = self.params, self.cfg, self.serve_mode
        state, tok, active, finite, noise = (self.state, self.tok, self.active, self.finite,
                                             self.noise)

        def fn():
            logits = decode_step_(params, cfg, state, tok, serve_mode=serve_mode, mask=active)
            nxt = sample(logits, temperature=temperature, top_k=top_k, noise=noise)
            finite.logical_and_(torch.isfinite(logits).all(-1) | ~active)
            tok.copy_(torch.where(active, nxt, tok))
            return logits
        self._steps[key] = Program(fn, self.device, capture=self.capture)
        return time.perf_counter() - t0

    def load(self, dstate: Dict, pos: int) -> None:
        """Every row's state from a decode state of ``batch`` rows at the
        host position ``pos``."""
        copy_state_(self.state, dstate)
        self.state["pos"].fill_(pos)

    def draw(self, generator: Optional[torch.Generator]) -> None:
        """Fresh noise for a sampled step, from ``generator``."""
        if self.noise is not None and generator is not None:
            self.noise.uniform_(0.0, 1.0, generator=generator)

    def step(self, temperature: float = 0.0, top_k: int = 0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One step of the active rows -> its fp32 logits [B, V] (valid
        until the next step). The sampler's step must have been prepared."""
        prog = self._steps[_sampler(temperature, top_k)]
        if not _greedy(temperature, top_k):
            self.draw(generator)
        return prog()

    def flush(self) -> None:
        """Flush the rows ``boundary`` marks."""
        self._flush()


class ServeEngine:
    """Serving of one model. serve_mode 'armt': constant-memory serving, per
    layer the recurrent state (ARMT's A/z plus a current-segment cache of
    seg_len + M rows, or Mamba's h and conv tail). 'cache': standard
    full-KV decoding (the baseline comparison), per attn layer a KV cache of
    ``max_len`` rows; a request's prompt plus its new tokens must fit it.

    schedule: the prefill's executor, 'diagonal' or 'sequential' (both on
    the fused cell; 'armt' mode only: cache mode prefills through
    ``decode_step``); the prefill runs eagerly.
    max_len: the KV cache's rows in cache mode; in 'armt' mode a pure-SSM
    model's piece of prompt per prefill (its seg_len); an ARMT model's
    seg_len is its segment.
    device: None means the CUDA device (raises without one); the CPU only
    when asked for.
    eager: on the card, run decode without CUDA graphs (the same programs,
    uncaptured), only to hold the graphs against it; the CPU never
    captures.
    prefix_cache / session_store: the serving state stores
    (``serve/state_store.py``). The prefix cache needs serve_mode 'armt'
    (its snapshots are the constant-size recurrent memory) and boundaries
    of the model's own segments (``segment_len(cfg)``): a pure-SSM engine's
    seg_len is ``max_len``, so it takes one only with max_len equal to it.
    telemetry: a ``Telemetry`` (default: metrics into the process registry,
    no trace).

    Decode programs are kept per batch size, one set for ``generate`` and
    one for ``serve``: one call of each at a time per engine."""

    def __init__(self, params: Dict, cfg: ArchConfig, *, serve_mode: str = "armt",
                 schedule: str = "diagonal", device=None, max_len: int = 8192,
                 eager: bool = False, prefix_cache=None, session_store=None,
                 telemetry: Optional[Telemetry] = None):
        check_serve_mode(serve_mode)
        if serve_mode == "armt" and cfg.armt is None and not cfg.is_recurrent:
            raise ValueError(f"serve_mode='armt' needs recurrent layer state, but "
                             f"{cfg.name} has cfg.armt=None and non-SSM layers: pass "
                             "serve_mode='cache' for full-KV decoding or add an "
                             "ARMTConfig to the arch")
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}; expected one of {SCHEDULES}")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.serve_mode = serve_mode
        self.schedule = schedule
        self.max_len = max_len
        self.seg_len = cfg.armt.segment_len if cfg.armt is not None else max_len
        self.flushes = serve_mode == "armt" and cfg.armt is not None
        self.capture = self.device.type == "cuda" and not eager
        self._programs: Dict = {}
        self._layout = StackLayout.from_config(cfg)
        self._n_layers = self._layout.n_layers
        # the blocking prefill's executor pair (forward_hidden's, fused):
        # the pipeline's band steps run the same cells
        self._apply = make_apply_block(cfg, "segmented")
        self._gapply = make_grouped_apply(cfg, "segmented")
        # the row of each segment a streaming carry keeps: the last prompt
        # token's, before the memory tokens (the last row without them)
        M = cfg.armt.num_mem_tokens if cfg.armt is not None else 0
        self._retain_pos = segment_len(cfg) - 1 if M else -1
        if prefix_cache is not None:
            if serve_mode != "armt":
                raise ValueError("prefix_cache needs serve_mode='armt': its snapshots are "
                                 "the recurrent memory at segment boundaries, which "
                                 "full-KV 'cache' mode does not have")
            if prefix_cache.seg_len != self.seg_len:
                raise ValueError(f"prefix_cache.seg_len {prefix_cache.seg_len} != engine "
                                 f"segment length {self.seg_len}: boundary hashes would "
                                 "never match this engine's prefill boundaries")
            if self.seg_len != segment_len(cfg):
                raise ValueError(
                    f"prefix_cache needs the engine's seg_len ({self.seg_len}, max_len for "
                    f"{cfg.name}) to be the model's segment ({segment_len(cfg)} tokens): "
                    "the prefill captures a state per model segment, so other boundaries "
                    "have no snapshot")
        self.prefix_cache = prefix_cache
        self.session_store = session_store
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        reg = self.telemetry.registry
        if reg is not None:
            # sampled at snapshot time: always current, nothing per chunk. The
            # probes hold the engine weakly: a process-wide registry must not
            # keep an engine's weights and stores on the card
            me = weakref.ref(self)
            reg.register_probe("engine_program_counts",
                               lambda: me() and me().program_counts())
            if prefix_cache is not None:
                reg.register_probe("prefix_cache",
                                   lambda: me() and me().prefix_cache.stats.as_dict())
            if session_store is not None:
                reg.register_probe("session_store",
                                   lambda: me() and me().session_store.stats.as_dict())

    # ------------------------------------------------------------------
    # Telemetry
    # ------------------------------------------------------------------

    def program_counts(self) -> Dict[str, int]:
        """The engine's decode programs: steps (one per batch size, serve or
        generate, and sampler) and flushes, and how many of them are
        captured CUDA graphs (the counterpart of the reference's jit-cache
        sizes; the process's captures and kernel build are the default
        registry's probes)."""
        progs = [p for prog in self._programs.values()
                 for p in list(prog._steps.values()) + [prog._flush] if p is not None]
        steps = sum(len(prog._steps) for prog in self._programs.values())
        return {"decode_steps": steps, "flushes": len(progs) - steps,
                "captured": sum(p.graph is not None for p in progs), "total": len(progs)}

    def metrics_snapshot(self) -> Dict:
        """The registry's snapshot with the engine's program counts and its
        stores' stats beside it (empty counters when metrics are off)."""
        snap = self.telemetry.snapshot() or {}
        snap["program_counts"] = self.program_counts()
        if self.prefix_cache is not None:
            snap["prefix_cache"] = self.prefix_cache.stats.as_dict()
        if self.session_store is not None:
            snap["session_store"] = self.session_store.stats.as_dict()
        return snap

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def program(self, batch: int, kind: str = "generate") -> DecodeProgram:
        """The engine's decode program of ``batch`` rows for ``kind``
        ('generate' or 'serve')."""
        key = (kind, batch)
        if key not in self._programs:
            self._programs[key] = DecodeProgram(self, batch)
        return self._programs[key]

    def _check_frames(self, enc_frames) -> None:
        if self.cfg.encoder is None and enc_frames is not None:
            raise ValueError(f"{self.cfg.name} has no encoder: enc_frames is for whisper")
        if self.cfg.encoder is not None and enc_frames is None:
            raise ValueError(f"{self.cfg.name} needs enc_frames, the stub frontend's frame "
                             f"embeddings [B, {self.cfg.encoder.n_frames}, "
                             f"{self.cfg.d_model}]")

    def _refuse_encoder(self, what: str) -> None:
        if self.cfg.encoder is not None:
            raise ValueError(f"{what} is not ported for an encoder config ({self.cfg.name}): "
                             "use generate(..., enc_frames=)")

    @torch.no_grad()
    def prefill(self, prompts: torch.Tensor, enc_frames=None):
        """prompts: [B, P] -> (next-token logits [B, V] fp32, decode state,
        position: in-segment, or in cache mode the tokens in the cache, a
        host int as is the state's ``pos``; segments taken from the prefix
        cache).

        With a prefix cache (B = 1, at least one whole segment): the longest
        cached prefix is transplanted, only the segments after it are
        prefilled, capturing their boundary states, and each new boundary's
        snapshot is inserted. An exact full-prefix hit runs no forward: its
        logits are the snapshot's.

        An encoder config (whisper) needs enc_frames [B, F, D], the stub
        frontend's frame embeddings: the encoder runs once, on the kernels,
        and every dec layer's cross K/V is written in place into the
        decode state's ck/cv, in both serve modes, whatever the prompt's
        length; the whole segments' forward reads the same ck/cv (shared,
        not copied). The prefix cache is skipped then, as in the
        reference: its snapshots do not hold the frames."""
        B, P = prompts.shape
        self._check_frames(enc_frames)
        if self.serve_mode == "cache" and P > self.max_len:
            raise ValueError(f"prompt_len {P} exceeds max_len {self.max_len} of the "
                             "KV cache")
        dstate = self.decode_state(B)
        n_full = P // self.seg_len if self.serve_mode == "armt" else 0
        logits, state0 = None, None
        if enc_frames is not None:
            frames = torch.as_tensor(enc_frames).to(self.device)
            if frames.shape != (B, self.cfg.encoder.n_frames, self.cfg.d_model):
                raise ValueError(f"enc_frames {tuple(frames.shape)} for {B} prompts: expected "
                                 f"[{B}, {self.cfg.encoder.n_frames}, {self.cfg.d_model}]")
            with self.telemetry.span("encode", "prefill", batch=B):
                fill_cross_kv_(self.params, self.cfg, dstate,
                               encode(self.params, self.cfg, frames))
            if n_full:
                state0 = init_state(self.cfg, B, self.device, self.params["embed"].dtype,
                                    cross_from=dstate)
        cached, snap, prompt_np, chain = (self._probe(prompts, n_full) if enc_frames is None
                                          else (0, None, None, None))
        if cached:
            state0, logits = snap.state, snap.logits.clone()
            if cached == n_full:
                _transplant(state0, dstate)
        prompts = prompts.to(self.device)
        if n_full > cached:
            out = self._prefill_full(prompts[:, cached * self.seg_len:n_full * self.seg_len],
                                     state0, capture=chain is not None)
            if chain is not None:
                self._insert_boundaries(prompt_np, chain, cached, out[0], out[2])
            logits = last_logits(self.params, self.cfg, out[0])
            _transplant(out[1], dstate)
            del out
        tail = prompts[:, n_full * self.seg_len:]
        if tail.shape[1]:
            logits = self._chunk(dstate, tail)
        if logits is None:
            raise ValueError("empty prompt")
        return logits, dstate, dstate["pos"], cached

    def _probe(self, prompts, n_full: int):
        """The prefix cache's match for a prompt of ``n_full`` whole
        segments -> (cached segments, snapshot or None, the prompt as int32
        numpy, its hash chain); the last two None when the cache does not
        apply: no cache, B > 1, or no whole segment."""
        if self.prefix_cache is None or prompts.shape[0] != 1 or not n_full:
            return 0, None, None, None
        prompt_np = np.asarray(prompts[0].cpu(), np.int32)
        chain = prefix_hash_chain(prompt_np, self.seg_len)
        with self.telemetry.span("prefix_probe", "cache", n_segments=n_full):
            n, snap = self.prefix_cache.match(prompt_np, chain=chain)
        self.telemetry.inc("prefix_probe_total", result="hit" if n else "miss")
        return n, snap, prompt_np, chain

    def _insert_boundaries(self, prompt_np, chain, off: int, hidden: torch.Tensor,
                           states: Dict) -> None:
        """One snapshot per boundary of the segments prefilled from segment
        ``off``: its recurrent leaves (``states``, leading [S]) and the
        boundary's logits (``boundary_logits`` of ``hidden`` [S, 1, T, D]),
        each a copy of its own, so that no snapshot keeps the capture alive
        or shares storage with an executor."""
        blogits = boundary_logits(self.params, self.cfg, hidden)
        for c in range(hidden.shape[0]):
            snap = {part: tuple({k: v[c].clone() for k, v in tree.items()}
                                for tree in states[part]) for part in ("prelude", "pattern")}
            self.prefix_cache.insert(prompt_np[:(off + c + 1) * self.seg_len], snap,
                                     blogits[c].clone(), key=chain[off + c])

    def restored(self, entry) -> Dict:
        """A fresh B = 1 decode state holding a stored session's leaves (a
        copy: what it runs updates in place) at the entry's position."""
        dstate = self.decode_state(1)
        copy_state_(dstate, entry.state)
        dstate["pos"] = entry.pos
        return dstate

    def resume(self, entry, prompt):
        """Resume a stored session with this turn's tokens [P]: its state
        restored, then the pending token and the prompt through ``_chunk``
        from the stored position. -> (logits [1, V], decode state, pos)."""
        dstate = self.restored(entry)
        feed = np.concatenate([entry.pending, np.asarray(prompt, np.int64)])
        logits = self._chunk(dstate, torch.from_numpy(feed).long()[None].to(self.device))
        return logits, dstate, dstate["pos"]

    def session_len_error(self, entry, P: int, max_new: int) -> Optional[str]:
        """Cache mode: why a turn of P prompt tokens and max_new new ones does
        not fit the KV cache after the session's stored tokens (none on a
        first turn), or None when it fits."""
        if self.serve_mode != "cache":
            return None
        base = entry.pos + len(entry.pending) if entry is not None else 0
        if base + P + max_new <= self.max_len:
            return None
        return (f"prompt_len {P} + max_new {max_new} (+{base} session tokens) exceeds "
                f"max_len {self.max_len} of the KV cache")

    def decode_state(self, batch: int, per_slot_pos: bool = False) -> Dict:
        """A zero decode state of this engine's serve mode for ``batch`` rows."""
        return decode_state_init(self.cfg, batch, dtype=self.params["embed"].dtype,
                                 device=self.device, serve_mode=self.serve_mode,
                                 max_len=self.max_len, per_slot_pos=per_slot_pos)

    def _cuts(self, T: int):
        """The token ends of the forward calls that prefill T tokens of whole
        pieces in the model's segments: one call, or, when T is not a whole
        number of segments, the whole ones and then one shorter segment."""
        seg = segment_len(self.cfg)
        return [T] if T <= seg or T % seg == 0 else [T - T % seg, T]

    def _prefill_full(self, toks: torch.Tensor, state0: Optional[Dict] = None, *,
                      capture: bool = False):
        """The prefill of whole pieces in the model's segments (``_cuts``),
        each call from the state the one before left (exact: the state is
        layer-local), the first from state0 (zero memory when None; not
        modified). -> (hidden, final state), and with capture the boundary
        states (one call: a prefix cache needs seg_len = the segment)."""
        state, start = state0, 0
        for end in self._cuts(toks.shape[1]):
            out = forward_hidden(self.params, self.cfg, toks[:, start:end],
                                 schedule=self.schedule, fused=True, state0=state,
                                 eager=True, capture_states=capture)
            state, start = out[1], end
        return out

    def _chunk(self, dstate, toks: torch.Tensor):
        """Feed a token chunk through the decode step, in place, in the
        pieces of ``_tail_pieces``. -> the last logits."""
        logits = None
        for piece in _tail_pieces(self, toks.shape[1], dstate["pos"]):
            logits = self._tail_piece(dstate, toks, piece)
        return logits

    def _tail_piece(self, dstate, toks: torch.Tensor, piece):
        """One piece (start, take, flush) of a token feed, in place -> its
        last logits."""
        t, take, flush = piece
        logits = decode_step_(self.params, self.cfg, dstate, toks[:, t:t + take],
                              serve_mode=self.serve_mode)
        if flush:
            with self.telemetry.span("flush_segment", "flush", take=take):
                flush_segment_(self.params, self.cfg, dstate)
        return logits

    # ------------------------------------------------------------------
    # Resumable prefill pipeline (interleaved admission)
    # ------------------------------------------------------------------

    def _exec_params(self) -> Dict:
        return {"prelude": self.params["prelude"], "pattern": self.params["pattern"]}

    @torch.no_grad()
    def prefill_step(self, xs: torch.Tensor, carry: Dict, n_groups: int) -> Dict:
        """Advance one suspended diagonal stage (``diag.pipeline_init``'s
        carry over the embedded segments ``xs``) by ``n_groups`` band
        steps, in place, on the blocking prefill's cells."""
        with torch.profiler.record_function("serve.diag_stage"):
            return diag.pipeline_step(self._layout, self._exec_params(), xs, carry,
                                      self._apply, n_groups=n_groups,
                                      grouped_apply=self._gapply,
                                      retain_pos=self._retain_pos)

    @torch.no_grad()
    def pool_prefill_step_run(self, n_groups: int, group) -> list:
        """Advance every member of ``group``, ``[(pipe, xs, carry), ...]``,
        by ``n_groups`` band steps through one pooled step
        (``diag.pipeline_step_pool``: one cell call per step over all the
        members' bands for the attn cell; one member after another for
        the mamba cell), in place -> the carries in member order."""
        with torch.profiler.record_function("serve.pooled_diag_round"):
            return diag.pipeline_step_pool(self._layout, self._exec_params(),
                                           [xs for _, xs, _ in group],
                                           [c for _, _, c in group], self._apply,
                                           n_groups=n_groups, grouped_apply=self._gapply,
                                           retain_pos=self._retain_pos)

    def _segment_rows(self) -> int:
        """T, the rows of one segment: seg_len tokens and the memory tokens."""
        return self.seg_len + (self.cfg.armt.num_mem_tokens if self.cfg.armt is not None else 0)

    def prefill_carry_bytes(self, n_segments: int, batch: int = 1, *,
                            stream: bool = True) -> int:
        """The carry of one suspended diagonal stage of ``n_segments``
        segments, in units of one [B, seg_len + M, D] segment: the embedded
        segments (S), the slot buffer (L), and the outputs, ``win`` (min(L,
        S)) and ``brow`` (S rows) when streaming, else ``ys`` (S). The
        reference's estimate counts S + L - 1 input segments, its drain
        padding; the port reads the S segments themselves."""
        cfg = self.cfg
        item = self.params["embed"].element_size()
        seg = batch * self._segment_rows() * cfg.d_model * item
        L, S = self._n_layers, n_segments
        total = (S + L) * seg
        if stream:
            total += min(L, S) * seg + S * batch * cfg.d_model * item
        else:
            total += S * seg
        return total

    def prefill_activation_bytes(self, n_segments: int, batch: int = 1, *,
                                 stream: bool = True) -> int:
        """Host estimate of the device bytes one admission of ``n_segments``
        whole segments holds at its peak; the scheduler's byte budget reads
        it per request. It adds:

          * the carry (``prefill_carry_bytes``);
          * two executor states (the stage's own copy and the one chained
            from the stage before) and the decode state the tail fills;
          * what the cells hold at their peak over the widest band, min(L,
            S) layers. With one pattern position: the pattern's cell over
            min(n_super, S) layers, or a prelude layer's cell alone,
            whichever is more. With several (jamba), whose cells run one
            after another in a step and whose outputs are all held until it
            ends: the band's min(L, S) outputs, plus the largest of the
            positions' cells over its layers in the band, each layer's count
            with one more D-wide copy (a strided band's input reshaped to N
            rows). Per group of B * T rows: the attn cell at its down
            projection (gate, up and their product, F wide each, F the
            prelude's width in a prelude layer, over only min(T,
            cell_block) rows when the FFN is blockwise, and then one more
            D-wide output; q, k, v; seven D-wide activations; a pooled
            step's copy of the band); the attn_moe cell at the larger of its attention
            (the attn cell without the FFN) and its MoE: the eight D-wide
            activations and the largest of the MoE's phases, which run one
            after another: the router (x in fp32, the logits, their
            softmax), per dispatch group of capacity C the expert products
            (E * C rows of the dispatch buffer and the gate product, and
            either the up product or the experts' output, F and D wide),
            the combine (the experts' output, the fp32 accumulator and a
            term, a gathered row and its gated copy) and the shared expert
            (its three activations, the routed output, its down product and
            the sum); the mamba cell at its scan (the in
            projection, 2 d_inner wide; the conv's input and output, dt and
            the scan's output, d_inner each; three D-wide), plus its FFN:
            a dense one's F-wide three and three D-wide, or the MoE as
            attn_moe's with its eight D-wide activations; and three
            copies of a layer's recurrent state (the new one, the memory
            update's, a pooled step's).

        With a prefix cache an admission captures its boundary states, and
        it also holds, at its end, the per-step capture (S + L - 1 stacked
        states) beside the boundaries gathered from it (S) or their
        snapshots (S), and the boundaries' logits (fp32 [S, V], the bf16
        product before it and the snapshots' copies).

        An encoder config (whisper) also holds its cross K/V, in the decode
        state (the executor states share it, so they count only their
        recurrent leaves), and before the forward the encoder's transients
        over its B * F frames: a layer's cell (eight D-wide activations, q,
        k and v, the F-wide MLP product and its GELU input) and the cross
        K/V fill's input (the encoder's output repeated over the decoder's
        layers); the larger of that and the band's is counted.

        A pooled round holds the sum of its members'. Host arithmetic only:
        the states are counted on the meta device."""
        cfg = self.cfg
        meta = torch.device("meta")
        dtype = self.params["embed"].dtype
        item = self.params["embed"].element_size()
        L, S = self._n_layers, n_segments
        state = tree_nbytes(recurrent_state(init_state(cfg, batch, meta, dtype)))
        dstate = tree_nbytes(decode_state_init(
            cfg, batch, dtype=dtype, device=meta, serve_mode=self.serve_mode,
            max_len=self.max_len))
        rows, D = batch * self._segment_rows(), cfg.d_model
        lay = self._layout

        cb = cfg.cell_block
        blocked = 0 < cb < self._segment_rows()
        rows_f = batch * cb if blocked else rows     # the F-wide rows live at once

        def moe_bytes() -> int:
            m = cfg.moe
            Q = batch if m.dispatch == "per_row" and batch > 1 else 1
            C = capacity(rows // Q, m)
            E, F = m.n_experts, m.d_expert
            return max(rows * 4 * (D + 3 * E),
                       Q * E * C * max(2 * D + F, D + 2 * F) * item,
                       Q * E * C * D * item + rows * D * (8 + 2 * item),
                       rows * (3 * D + 3 * m.d_shared) * item)

        def ffn_bytes(F: int) -> int:
            return rows_f * 3 * F * item + (rows * D * item if blocked else 0)

        def cell(t: str, prelude: bool) -> int:
            """One layer's transients at its cell's peak."""
            F = block_d_ff(cfg, t, prelude)
            if t in MAMBA_TYPES:
                mixer = rows * (3 * D + 6 * cfg.ssm.expand * D) * item
                if t == "mamba_moe":
                    return mixer + rows * 8 * D * item + moe_bytes()
                return mixer + (ffn_bytes(F) + rows * 3 * D * item if F else 0)
            width = 8 * D + (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
            if t != "attn_moe":
                return rows * width * item + ffn_bytes(F)
            return max(rows * width * item, rows * 8 * D * item + moe_bytes())

        if len(lay.pattern) == 1:
            band = max([cell(t, True) for t in lay.prelude]
                       + [min(lay.n_super, S) * cell(lay.pattern[0], False)])
        else:
            w = min(L, S)
            n_in = min(lay.n_super, -(-w // len(lay.pattern)))
            band = w * rows * D * item + max(n_in * (cell(t, False) + rows * D * item)
                                             for t in set(lay.pattern))
        if cfg.encoder is not None:
            frames = batch * cfg.encoder.n_frames
            band = max(band, frames * item * (
                8 * D + (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim + 2 * cfg.d_ff
                + lay.n_super * D))
        total = (self.prefill_carry_bytes(S, batch, stream=stream) + 2 * state + dstate
                 + band + min(L, S) * (3 * state // L))
        if self.prefix_cache is not None:
            total += (2 * S + L - 1) * state + S * batch * cfg.vocab * (8 + item)
        return total

    def start_prefill(self, prompts, *, groups_per_call: Optional[int] = 4,
                      session_entry=None, stream: bool = False,
                      max_stage_segments: Optional[int] = None) -> "PrefillPipeline":
        """A resumable admission of ``prompts`` [B, P]: a ``PrefillPipeline``
        whose ``advance()`` runs ``groups_per_call`` band steps of its
        current diagonal stage (None: the whole stage), or one tail piece;
        its ``result()`` is ``prefill(prompts)``'s. session_entry: resume a
        stored session instead (B = 1): the entry's pending tokens and the
        prompt are fed as tail pieces from its position.

        stream: the diagonal stages carry ``win``/``brow`` in place of the
        full ``ys`` (bounded memory; the same logits and state).
        max_stage_segments: cut the whole segments into stages of at most
        this many (the largest power of two under it, then the remainder's
        powers of two, as the reference does), the state chained across
        them; the scheduler's byte budget sets it with ``stream``."""
        self._refuse_encoder("interleaved admission (start_prefill)")
        return PrefillPipeline(self, prompts, groups_per_call=groups_per_call,
                               session_entry=session_entry, stream=stream,
                               max_stage_segments=max_stage_segments)

    @torch.no_grad()
    def generate(self, prompts, max_new: int, *, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, keep: bool = False,
                 session_id: Optional[str] = None, enc_frames=None) -> GenerationResult:
        """Decode max_new tokens after the prompt [B, P]: greedy when
        temperature <= 0 (the default), else temperature / top-k sampling
        on the device (``sample``) from a generator seeded with ``seed``.
        Token 0 comes from the prefill's logits; the last token is never fed
        back. One device-to-host transfer for the whole call. keep: also
        return every token's logits and a copy of the final decode state.

        session_id (B = 1, the engine's session store): when the store holds
        this conversation, resume it: the prompt is this turn's tokens only,
        fed after the stored pending token from the stored state, and the
        history is not computed again (an evicted session raises
        ``SessionEvicted``). Either way the end state is stored under the
        id, with the last token, never fed, as the next turn's pending.

        enc_frames: an encoder config's frame embeddings [B, F, D] (see
        ``prefill``); the decode program's static cross K/V take them by a
        copy into the buffers its graphs were captured on. Sessions of an
        encoder config are not ported (a ValueError)."""
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long)
        B, P = prompts.shape
        self._check_frames(enc_frames)
        entry = None
        if session_id is not None:
            self._refuse_encoder("session_id=")
            if self.session_store is None:
                raise ValueError("session_id given but the engine has no session_store")
            if B != 1:
                raise ValueError("sessions are per conversation: B must be 1")
            entry = self.session_store.get(session_id)      # None on a first turn
        err = self.session_len_error(entry, P, max_new)
        if err is not None:
            raise ValueError(err)
        tel = self.telemetry
        gen = None
        if not _greedy(temperature, top_k):
            gen = torch.Generator(device=self.device).manual_seed(seed)
        prog = self.program(B)
        capture_s = prog.prepare(temperature, top_k)
        t0 = time.perf_counter()
        cached = 0
        if entry is not None:
            with tel.span("session_restore", "session", session=session_id):
                logits, dstate, pos = self.resume(entry, prompts[0].numpy())
        else:
            with tel.span("prefill", "prefill", prompt_len=P, batch=B):
                logits, dstate, pos, cached = self.prefill(prompts, enc_frames)
        prog.load(dstate, pos)
        del dstate
        prog.draw(gen)
        prog.tok.copy_(sample(logits, temperature=temperature, top_k=top_k,
                              noise=prog.noise))
        prog.finite.copy_(torch.isfinite(logits).all(-1))
        prog.active.fill_(True)
        prog.boundary.fill_(True)
        self._sync()
        t_first = time.perf_counter()
        toks = torch.empty(B, max_new, dtype=torch.long, device=self.device)
        toks[:, 0] = prog.tok
        kept = [logits] if keep else None
        with tel.span("decode", "decode", max_new=max_new), \
                torch.profiler.record_function("serve.decode_loop"):
            for i in range(1, max_new):
                step_logits = prog.step(temperature, top_k, gen)
                if keep:
                    kept.append(step_logits.clone())
                pos += 1
                if self.flushes and pos >= self.seg_len:
                    prog.flush()
                    pos = 0
                toks[:, i] = prog.tok
            host = torch.cat([toks.reshape(-1), prog.finite.all().long()[None]]).cpu().numpy()
        t_end = time.perf_counter()
        tokens = host[:-1].reshape(B, max_new)
        tok_s = B * max(max_new - 1, 0) / max(t_end - t_first, 1e-9)
        tel.observe("generate_ttft_s", t_first - t0)
        tel.observe("generate_decode_tok_s", tok_s)
        if session_id is not None:
            history = np.concatenate([entry.tokens if entry is not None
                                      else np.empty(0, np.int32), prompts[0].numpy(),
                                      tokens[0]]).astype(np.int32)
            # a copy: the program's state is the next call's
            self.session_store.put(session_id, state=clone_state(
                {"prelude": prog.state["prelude"], "pattern": prog.state["pattern"]}),
                pos=pos, pending=tokens[0, -1:], tokens=history)
        return GenerationResult(
            tokens, P // self.seg_len, finite=bool(host[-1]),
            ttft_s=t_first - t0, tok_s=tok_s, capture_s=capture_s,
            logits=torch.stack(kept, dim=1) if keep else None,
            state=clone_state(prog.state) if keep else None,
            cached_segments=cached, session_id=session_id, resumed=entry is not None,
            metrics=self.metrics_snapshot() if tel.registry is not None else None)

    def serve(self, requests: Iterable, *, n_slots: int = 4, chunk: int = 8,
              max_queue: Optional[int] = None, prefill_groups_per_chunk: int = 4,
              fused_admission: bool = False,
              max_concurrent_admissions: Optional[int] = None,
              admission_fairness: str = "round_robin",
              admission_byte_budget: Optional[int] = None) -> Iterator:
        """Continuous-batching streaming front door: admit ``Request``s into
        ``n_slots`` decode slots and yield ``StreamEvent``s as tokens reach
        the host (once per ``chunk`` decode steps). Rejections (invalid
        request, evicted session, full queue) come back as ``RequestError``
        events on the same stream. A request with a ``session_id`` resumes
        or starts that conversation in the engine's session store.

        prefill_groups_per_chunk: an admission's prefill advances this many
        band steps per decode chunk (interleaved admission, the default 4);
        -1 a whole diagonal stage per chunk; 0 blocks, prefilling each
        request alone between chunks. fused_admission: enqueue each round's
        decode chunk first and the admissions' band steps right after it,
        before the chunk's tokens are read (see ``ContinuousScheduler``).
        max_concurrent_admissions: admissions in flight at once (None: as
        many as free slots). admission_fairness: 'round_robin' (every
        admission advances each round) or 'oldest_first'.
        admission_byte_budget: a prompt whose prefill would hold more
        device bytes at its peak (``prefill_activation_bytes``: the carry,
        the states and the band's transients) goes through the streaming
        carry in stages that fit; None: no budget."""
        self._refuse_encoder("serve()")
        sched = ContinuousScheduler(self, n_slots=n_slots, chunk=chunk, max_queue=max_queue,
                                    prefill_groups_per_chunk=prefill_groups_per_chunk,
                                    fused_admission=fused_admission,
                                    max_concurrent_admissions=max_concurrent_admissions,
                                    admission_fairness=admission_fairness,
                                    admission_byte_budget=admission_byte_budget)
        return sched.run(requests)


def _tail_pieces(engine: ServeEngine, total: int, pos: int):
    """A token feed of ``total`` tokens from in-segment position ``pos``
    cut into decode-step pieces: [(start, take, flush_after), ...]. A piece
    ends at the segment boundary, where an ARMT model flushes; a model that
    never flushes (cache mode, or a pure-SSM model, whose position only
    grows: a resumed session's may be past seg_len) takes the feed as one
    piece. The one decomposition of the blocking ``_chunk`` and of the
    pipeline's tail pieces, so the two cannot drift."""
    pieces = []
    t = 0
    while t < total:
        room = engine.seg_len - pos if engine.flushes else total - t
        take = min(room, total - t)
        pos += take
        flush = engine.flushes and pos >= engine.seg_len
        pieces.append((t, take, flush))
        if flush:
            pos = 0
        t += take
    return pieces


def _pow2_chunks(n: int):
    """Descending powers of two summing to n (13 -> [8, 4, 1])."""
    out = []
    while n > 0:
        p = 1 << (n.bit_length() - 1)
        out.append(p)
        n -= p
    return out


class PrefillPipeline:
    """A suspended, resumable admission: ``ServeEngine.prefill`` cut into
    bounded units that ``advance()`` runs one at a time.

    Its stages follow the blocking prefill: the prompt's whole pieces as
    diagonal stages (in the model's segments, ``ServeEngine._cuts``; with
    ``max_stage_segments`` cut into several stages, the state chained
    across them), each advanced ``groups_per_call`` band steps per
    ``advance()`` (``ServeEngine.prefill_step``); then the tail, one piece
    per ``advance()`` (``_tail_pieces``). After the last diagonal stage the
    final state is transplanted into a fresh decode state, which the tail
    pieces update in place. The band steps are the one-shot executor's and
    the tail pieces the blocking ``_chunk``'s, so ``result()`` equals
    ``prefill()``'s to the bit.

    With the engine's prefix cache, the prompt is matched when the pipeline
    is made, as ``prefill`` does: the diagonal stages start after the
    cached segments, from the snapshot's state, and capture their boundary
    states, which ``_finish_diag`` inserts; an exact full hit is
    transplanted at once. With a session entry the pipeline is the resume's
    tail pieces only, from the entry's position.

    Every carry is the pipeline's own (``diag.pipeline_init`` copies the
    state, a snapshot's too), so decode chunks that update the scheduler's
    pool in place between ``advance()`` calls cannot touch a suspended
    admission, nor can an admission touch a store's entry."""

    def __init__(self, engine: ServeEngine, prompts, *,
                 groups_per_call: Optional[int] = 4, session_entry=None,
                 stream: bool = False, max_stage_segments: Optional[int] = None):
        if groups_per_call is not None and groups_per_call < 1:
            raise ValueError(f"groups_per_call must be >= 1 or None (a whole stage per "
                             f"advance), got {groups_per_call}")
        if max_stage_segments is not None and max_stage_segments < 1:
            raise ValueError(f"max_stage_segments must be >= 1, got {max_stage_segments}")
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long)
        if prompts.dim() != 2:
            raise ValueError(f"prompts must be [B, P], got {tuple(prompts.shape)}")
        self.engine = engine
        self.groups_per_call = groups_per_call
        self._stream = bool(stream)
        self.prompts = prompts.to(engine.device)
        self.B, P = prompts.shape
        if engine.serve_mode == "cache" and P > engine.max_len:
            raise ValueError(f"prompt_len {P} exceeds max_len {engine.max_len} of the "
                             "KV cache")
        self._logits = None
        self._exec_state = None
        self._xs = self._carry = None
        self._groups_done = self._n_steps = 0
        self._stage = 0
        self._stages = []      # ("diag", t0, t1, seg) | ("tail", start, take, flush)
        self.cached = 0
        self._prompt_np = self._chain = None
        if session_entry is not None:
            if self.B != 1:
                raise ValueError("sessions are per conversation: B must be 1")
            with engine.telemetry.span("session_restore", "session"):
                self._dstate = engine.restored(session_entry)
            feed = np.concatenate([session_entry.pending, prompts[0].numpy()])
            self._tail = torch.from_numpy(feed).long()[None].to(engine.device)
            self._stages = [("tail",) + piece for piece in _tail_pieces(
                engine, self._tail.shape[1], session_entry.pos)]
            self._done = False
            return
        self._dstate = engine.decode_state(self.B)
        n_full = P // engine.seg_len if engine.serve_mode == "armt" else 0
        if n_full and engine.schedule != "diagonal":
            raise ValueError("start_prefill needs the diagonal schedule for its "
                             f"segment stages (engine.schedule={engine.schedule!r})")
        self.cached, snap, self._prompt_np, self._chain = engine._probe(prompts, n_full)
        if self.cached:
            self._exec_state, self._logits = snap.state, snap.logits.clone()
            if self.cached == n_full:       # nothing left for the executor
                _transplant(snap.state, self._dstate)
        rem = n_full - self.cached
        if max_stage_segments is not None and rem > max_stage_segments:
            cap = 1 << (max_stage_segments.bit_length() - 1)
            groups = [cap] * (rem // cap) + _pow2_chunks(rem % cap)
        else:
            groups = [rem] if rem else []
        off = self.cached
        for g in groups:
            t0 = off * engine.seg_len
            start = 0
            for end in engine._cuts(g * engine.seg_len):
                seg = min(segment_len(engine.cfg), end - start)
                self._stages.append(("diag", t0 + start, t0 + end, seg))
                start = end
            off += g
        self._tail = self.prompts[:, n_full * engine.seg_len:]
        self._stages += [("tail",) + piece
                         for piece in _tail_pieces(engine, self._tail.shape[1], 0)]
        self._done = not self._stages
        if self._done and self._logits is None:
            raise ValueError("empty prompt")

    # -- progress ------------------------------------------------------------

    @property
    def done(self) -> bool:
        return self._done

    def result(self):
        """(next-token logits [B, V] fp32, decode state, in-segment pos,
        cached segments), as ``ServeEngine.prefill`` returns them; once
        ``done``."""
        if not self._done:
            raise RuntimeError("the pipeline is not finished: keep calling advance()")
        return self._logits, self._dstate, self._dstate["pos"], self.cached

    def diag_segments(self) -> list:
        """(segments, groups run) of each diagonal stage not finished yet,
        from the host cursors."""
        out = []
        for idx, st in enumerate(self._stages[self._stage:]):
            if st[0] == "diag":
                done = self._groups_done if idx == 0 and self._carry is not None else 0
                out.append(((st[2] - st[1]) // st[3], done))
        return out

    # -- diagonal stages -----------------------------------------------------

    def _begin_diag(self, t0: int, t1: int, seg: int) -> None:
        eng = self.engine
        x = embed_segments(eng.params, eng.cfg, self.prompts[:, t0:t1], seg)
        state0 = self._exec_state
        if state0 is None:
            state0 = init_state(eng.cfg, self.B, eng.device, eng.params["embed"].dtype)
        self._xs, self._carry = diag.pipeline_init(eng._layout, state0, x,
                                                   capture_states=self._chain is not None,
                                                   stream_ys=self._stream)
        self._groups_done = 0
        self._n_steps = n_diagonal_groups(x.shape[0], eng._n_layers)

    def _finish_diag(self, seg: int) -> None:
        eng = self.engine
        t0 = self._stages[self._stage][1]
        out, fin, capd = diag.pipeline_finalize(eng._layout, self._carry)
        self._xs = self._carry = None       # the step capture goes with the carry
        # last_logits (and boundary_logits) read the last row of each
        # segment: brow's, or ys's with the memory-token rows stripped
        hidden = out["brow"][:, :, None, :] if self._stream else out[:, :, :seg]
        if capd is not None:
            eng._insert_boundaries(self._prompt_np, self._chain, t0 // eng.seg_len,
                                   hidden, capd)
            del capd
        self._logits = last_logits(eng.params, eng.cfg, hidden)
        self._exec_state = fin
        self._stage += 1
        if not any(st[0] == "diag" for st in self._stages[self._stage:]):
            _transplant(fin, self._dstate)

    def active_diag(self):
        """(segments, xs, carry) of the diagonal stage the next unit
        advances (begun if it was not yet), or None when the next unit is a
        tail piece or the pipeline is done."""
        if self._done or self._stages[self._stage][0] != "diag":
            return None
        _, t0, t1, seg = self._stages[self._stage]
        if self._carry is None:
            self._begin_diag(t0, t1, seg)
        return self._xs.shape[0], self._xs, self._carry

    def groups_per_advance(self) -> int:
        return self.groups_per_call or self._n_steps

    def apply_diag_result(self, carry) -> bool:
        """Account for ``groups_per_advance()`` band steps a pooled step ran
        on this pipeline's carry (in place) -> done, as ``advance()``."""
        if carry is not self._carry:
            raise ValueError("not this pipeline's carry")
        self._groups_done += self.groups_per_advance()
        if self._groups_done >= self._n_steps:
            self._finish_diag(self._stages[self._stage][3])
        self._done = self._stage >= len(self._stages)
        return self._done

    # -- advancing -----------------------------------------------------------

    @torch.no_grad()
    def advance(self) -> bool:
        """Run one bounded unit (band steps of the diagonal stage, or one
        tail piece) -> whether the admission is complete."""
        if self._done:
            return True
        if self.active_diag() is not None:
            self.engine.prefill_step(self._xs, self._carry, self.groups_per_advance())
            return self.apply_diag_result(self._carry)
        piece = self._stages[self._stage][1:]
        self._logits = self.engine._tail_piece(self._dstate, self._tail, piece)
        self._stage += 1
        self._done = self._stage >= len(self._stages)
        return self._done


class AdmissionPool:
    """Concurrent resumable admissions advanced together, FIFO. Each round
    every member advances one unit; the members whose next unit is a
    diagonal stage of one signature (batch, groups per advance) go through
    one pooled band step (``ServeEngine.pool_prefill_step_run``), the
    others advance alone. The pooled step takes members of any grid, at any
    cursor, streaming or not, so the signature holds only what one call
    needs alike; the reference also keys by segments and stream, for its
    compiles. Pooling batches device work only: every member's host state
    stays in its ``PrefillPipeline``, and its results are those of its own
    pipeline."""

    def __init__(self, engine: ServeEngine):
        self.engine = engine
        self.members: list = []

    def __len__(self) -> int:
        return len(self.members)

    def add(self, pipe: PrefillPipeline) -> None:
        self.members.append(pipe)

    def grid_cells_remaining(self) -> int:
        """(segment, layer) cells not yet run across every member's diagonal
        stages, from the host cursors."""
        total = 0
        for pipe in self.members:
            stages = pipe.diag_segments()
            total += pool_cells_remaining([d for _, d in stages], [s for s, _ in stages],
                                          self.engine._n_layers)
        return total

    def diag_buckets(self) -> Dict:
        """{(batch, k): [(pipe, xs, carry), ...]} of the members whose next
        unit is a diagonal stage, in member order."""
        buckets: Dict = {}
        for pipe in self.members:
            ad = pipe.active_diag()
            if ad is None:
                continue
            _, xs, carry = ad
            sig = (pipe.B, pipe.groups_per_advance())
            buckets.setdefault(sig, []).append((pipe, xs, carry))
        return buckets

    def advance_round(self):
        """One round: every member advances one unit; a bucket of two or
        more goes through one pooled step. -> the members that completed,
        FIFO, removed from the pool."""
        advanced = set()
        for (_, k), group in self.diag_buckets().items():
            if len(group) < 2:
                continue
            self.engine.pool_prefill_step_run(k, group)
            for pipe, _, carry in group:
                pipe.apply_diag_result(carry)
                advanced.add(id(pipe))
        done = []
        for pipe in list(self.members):
            if id(pipe) in advanced:
                if pipe.done:
                    done.append(pipe)
            elif pipe.advance():
                done.append(pipe)
        for pipe in done:
            self.members.remove(pipe)
        return done

    def advance_oldest(self):
        """Head-of-line: only the oldest member advances."""
        pipe = self.members[0]
        if pipe.advance():
            self.members.remove(pipe)
            return [pipe]
        return []
