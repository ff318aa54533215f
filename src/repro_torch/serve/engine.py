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
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.capture import Program
from repro_torch.core.memory import RECURRENT_KEYS
from repro_torch.core.sequential import clone_state
from repro_torch.models.model import (SCHEDULES, check_serve_mode, copy_state_,
                                      decode_state_init, decode_step_, flush_segment_,
                                      forward_hidden, last_logits, resolve_device,
                                      segment_len)
from repro_torch.serve.scheduler import ContinuousScheduler


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

    Decode programs are kept per batch size, one set for ``generate`` and
    one for ``serve``: one call of each at a time per engine."""

    def __init__(self, params: Dict, cfg: ArchConfig, *, serve_mode: str = "armt",
                 schedule: str = "diagonal", device=None, max_len: int = 8192,
                 eager: bool = False):
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

    @torch.no_grad()
    def prefill(self, prompts: torch.Tensor):
        """prompts: [B, P] -> (next-token logits [B, V] fp32, decode state,
        position: in-segment, or in cache mode the tokens in the cache, a
        host int as is the state's ``pos``)."""
        B, P = prompts.shape
        if self.serve_mode == "cache" and P > self.max_len:
            raise ValueError(f"prompt_len {P} exceeds max_len {self.max_len} of the "
                             "KV cache")
        prompts = prompts.to(self.device)
        dstate = self.decode_state(B)
        n_full = P // self.seg_len if self.serve_mode == "armt" else 0
        logits = None
        if n_full:
            hidden, fin = self._prefill_full(prompts[:, :n_full * self.seg_len])
            logits = last_logits(self.params, self.cfg, hidden)
            _transplant(fin, dstate)
        tail = prompts[:, n_full * self.seg_len:]
        if tail.shape[1]:
            logits = self._chunk(dstate, tail)
        if logits is None:
            raise ValueError("empty prompt")
        return logits, dstate, dstate["pos"]

    def decode_state(self, batch: int, per_slot_pos: bool = False) -> Dict:
        """A zero decode state of this engine's serve mode for ``batch`` rows."""
        return decode_state_init(self.cfg, batch, dtype=self.params["embed"].dtype,
                                 device=self.device, serve_mode=self.serve_mode,
                                 max_len=self.max_len, per_slot_pos=per_slot_pos)

    def _prefill_full(self, toks: torch.Tensor):
        """The prefill of whole pieces in the model's segments; a
        length that is not a whole number of them ends in one shorter
        segment, run from the state the whole ones left (exact: the state is
        layer-local)."""
        seg, T = segment_len(self.cfg), toks.shape[1]
        cuts = [T] if T <= seg or T % seg == 0 else [T - T % seg, T]
        state, start = None, 0
        for end in cuts:
            hidden, state = forward_hidden(self.params, self.cfg, toks[:, start:end],
                                           schedule=self.schedule, fused=True,
                                           state0=state, eager=True)
            start = end
        return hidden, state

    def _chunk(self, dstate, toks: torch.Tensor):
        """Feed a token chunk through the decode step, in place, in pieces
        that end at segment boundaries, flushing an ARMT model at each
        boundary; in cache mode as one piece. -> the last logits."""
        logits = None
        t = 0
        while t < toks.shape[1]:
            pos = dstate["pos"]
            room = self.seg_len - pos if self.serve_mode == "armt" else toks.shape[1] - t
            take = min(room, toks.shape[1] - t)
            logits = decode_step_(self.params, self.cfg, dstate, toks[:, t:t + take],
                                  serve_mode=self.serve_mode)
            t += take
            if self.flushes and dstate["pos"] >= self.seg_len:
                flush_segment_(self.params, self.cfg, dstate)
        return logits

    @torch.no_grad()
    def generate(self, prompts, max_new: int, *, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, keep: bool = False) -> GenerationResult:
        """Decode max_new tokens after the prompt [B, P]: greedy when
        temperature <= 0 (the default), else temperature / top-k sampling
        on the device (``sample``) from a generator seeded with ``seed``.
        Token 0 comes from the prefill's logits; the last token is never fed
        back. One device-to-host transfer for the whole call. keep: also
        return every token's logits and a copy of the final decode state."""
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long)
        B, P = prompts.shape
        if self.serve_mode == "cache" and P + max_new > self.max_len:
            raise ValueError(f"prompt_len {P} + max_new {max_new} (+0 session tokens) "
                             f"exceeds max_len {self.max_len} of the KV cache")
        gen = None
        if not _greedy(temperature, top_k):
            gen = torch.Generator(device=self.device).manual_seed(seed)
        prog = self.program(B)
        capture_s = prog.prepare(temperature, top_k)
        t0 = time.perf_counter()
        logits, dstate, pos = self.prefill(prompts)
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
        return GenerationResult(
            host[:-1].reshape(B, max_new), P // self.seg_len, finite=bool(host[-1]),
            ttft_s=t_first - t0,
            tok_s=B * max(max_new - 1, 0) / max(t_end - t_first, 1e-9),
            capture_s=capture_s,
            logits=torch.stack(kept, dim=1) if keep else None,
            state=clone_state(prog.state) if keep else None)

    def serve(self, requests: Iterable, *, n_slots: int = 4, chunk: int = 8,
              max_queue: Optional[int] = None,
              prefill_groups_per_chunk: int = 0) -> Iterator:
        """Continuous-batching streaming front door: admit ``Request``s into
        ``n_slots`` decode slots and yield ``StreamEvent``s as tokens reach
        the host (once per ``chunk`` decode steps). Rejections (invalid
        request, session_id, full queue) come back as ``RequestError``
        events on the same stream.

        Only blocking admission exists: each request is prefilled alone
        between decode chunks, the reference's ``prefill_groups_per_chunk=0``.
        Any other value raises, since the resumable prefill pipeline that
        interleaves admission with decoding is not ported."""
        if prefill_groups_per_chunk != 0:
            raise ValueError("only blocking admission is ported: "
                             "prefill_groups_per_chunk must be 0")
        sched = ContinuousScheduler(self, n_slots=n_slots, chunk=chunk,
                                    max_queue=max_queue)
        return sched.run(requests)
