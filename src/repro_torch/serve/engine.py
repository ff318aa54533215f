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
  3. decode: one ``decode_step`` per token (for ARMT models its attention on
     the decode-attention kernel, with ``flush_segment`` when the
     in-segment position reaches seg_len; for Mamba models the scan on the
     mamba_scan kernel).

With ``serve_mode="cache"`` (standard full-KV decoding, the paper's
baseline) the whole prompt is one ``decode_step`` chunk from position 0
into a KV cache of ``max_len`` rows (its attention on the flash kernel),
and every decoded token attends the whole cache prefix; nothing flushes.

An ARMT model's seg_len is its segment. A pure-SSM model (falcon-mamba) has
no segment boundary: its seg_len is ``max_len``, the largest piece of a
prompt that goes through the diagonal prefill at once, which runs it in
segments of ``DEFAULT_SEG_LEN`` tokens; it never flushes.

Positions are tracked on the host: every ``decode_step`` advances the
state's position by exactly the tokens fed.

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
from repro_torch.core.memory import RECURRENT_KEYS
from repro_torch.models.model import (SCHEDULES, check_serve_mode, decode_state_init,
                                      decode_step, flush_segment, forward_hidden,
                                      last_logits, resolve_device, segment_len)
from repro_torch.serve.scheduler import ContinuousScheduler


def _transplant(fin: Dict, dstate: Dict) -> Dict:
    """Copy the recurrent leaves (A/z) of an executor state into a decode
    state, which also holds the KV caches and pos."""
    def merge(src: Dict, dst: Dict) -> Dict:
        out = dict(dst)
        out.update({k: src[k].to(dst[k].dtype) for k in RECURRENT_KEYS if k in src})
        return out
    return {"prelude": tuple(merge(s, d) for s, d in zip(fin["prelude"], dstate["prelude"])),
            "pattern": tuple(merge(s, d) for s, d in zip(fin["pattern"], dstate["pattern"])),
            "pos": dstate["pos"]}


def sample(logits: torch.Tensor, *, temperature: float, top_k: int,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    """Next tokens [B] (int64) from fp32 logits [B, V], on their device.
    temperature <= 0 or top_k == 1: greedy (argmax, the first of tied
    maxima; generator unused). Otherwise a draw from softmax(logits /
    temperature), restricted to the top_k largest when top_k > 1 (ties with
    the k-th kept, as the reference's ``jax.lax.top_k`` mask), by the
    Gumbel-max trick: argmax of the scaled logits plus -log(-log u), u ~
    U[0, 1) from ``generator``.

    top_k == 1 is greedy by definition here: the reference's mask would keep
    every logit tied with the largest and draw among them, and bf16 logits
    over a 128k vocabulary do tie at the top."""
    if temperature <= 0.0 or top_k == 1:
        return logits.argmax(-1)
    scaled = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(scaled, min(top_k, scaled.shape[-1]), dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    return (scaled - torch.log(-torch.log(u))).argmax(-1)


@dataclass
class GenerationResult:
    tokens: np.ndarray          # [B, max_new]
    prefill_segments: int
    finite: bool = True         # every logit the tokens were taken from was finite
    ttft_s: float = 0.0         # prefill wall time, ending in a device sync
    tok_s: float = 0.0          # decode tokens (all rows) per second after the first


class ServeEngine:
    """Serving of one model. serve_mode 'armt': constant-memory serving, per
    layer the recurrent state (ARMT's A/z plus a current-segment cache of
    seg_len + M rows, or Mamba's h and conv tail). 'cache': standard
    full-KV decoding (the baseline comparison), per attn layer a KV cache of
    ``max_len`` rows; a request's prompt plus its new tokens must fit it.

    schedule: the prefill's executor, 'diagonal' or 'sequential' (both on
    the fused cell; 'armt' mode only: cache mode prefills through
    ``decode_step``).
    max_len: the KV cache's rows in cache mode; in 'armt' mode a pure-SSM
    model's piece of prompt per prefill (its seg_len); an ARMT model's
    seg_len is its segment.
    device: None means the CUDA device (raises without one); the CPU only
    when asked for."""

    def __init__(self, params: Dict, cfg: ArchConfig, *, serve_mode: str = "armt",
                 schedule: str = "diagonal", device=None, max_len: int = 8192):
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

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def prefill(self, prompts: torch.Tensor):
        """prompts: [B, P] -> (next-token logits [B, V] fp32, decode state,
        position: in-segment, or in cache mode the tokens in the cache)."""
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
            dstate = _transplant(fin, dstate)
        tail = prompts[:, n_full * self.seg_len:]
        pos = 0
        if tail.shape[1]:
            logits, dstate, pos = self._chunk(dstate, tail, pos)
        if logits is None:
            raise ValueError("empty prompt")
        return logits, dstate, pos

    def decode_state(self, batch: int, per_slot_pos: bool = False) -> Dict:
        """A zero decode state of this engine's serve mode for ``batch`` rows."""
        return decode_state_init(self.cfg, batch, dtype=self.params["embed"].dtype,
                                 device=self.device, serve_mode=self.serve_mode,
                                 max_len=self.max_len, per_slot_pos=per_slot_pos)

    def step(self, dstate: Dict, tokens: torch.Tensor):
        """``decode_step`` in this engine's serve mode."""
        return decode_step(self.params, self.cfg, dstate, tokens,
                           serve_mode=self.serve_mode)

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
                                           state0=state)
            start = end
        return hidden, state

    def _chunk(self, dstate, toks: torch.Tensor, pos: int):
        """Feed a token chunk through ``decode_step`` in pieces that end at
        segment boundaries, flushing an ARMT model at each boundary; in
        cache mode as one piece."""
        logits = None
        t = 0
        while t < toks.shape[1]:
            room = self.seg_len - pos if self.serve_mode == "armt" else toks.shape[1] - t
            take = min(room, toks.shape[1] - t)
            logits, dstate = self.step(dstate, toks[:, t:t + take])
            pos += take
            t += take
            if self.flushes and pos >= self.seg_len:
                dstate = flush_segment(self.params, self.cfg, dstate)
                pos = 0
        return logits, dstate, pos

    @torch.no_grad()
    def generate(self, prompts, max_new: int, *, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0) -> GenerationResult:
        """Decode max_new tokens after the prompt [B, P]: greedy when
        temperature <= 0 (the default), else temperature / top-k sampling
        on the device (``sample``) from a generator seeded with ``seed``.
        Token 0 comes from the prefill's logits; the last token is never fed
        back. One device-to-host transfer for the whole call."""
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long)
        B, P = prompts.shape
        if self.serve_mode == "cache" and P + max_new > self.max_len:
            raise ValueError(f"prompt_len {P} + max_new {max_new} (+0 session tokens) "
                             f"exceeds max_len {self.max_len} of the KV cache")
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)

        def pick(logits):
            return sample(logits, temperature=temperature, top_k=top_k, generator=gen)
        t0 = time.perf_counter()
        logits, dstate, pos = self.prefill(prompts)
        tok = pick(logits)
        finite = torch.isfinite(logits).all()     # stays on the device until the end
        self._sync()
        t_first = time.perf_counter()
        out = [tok]
        for _ in range(max_new - 1):
            logits, dstate = self.step(dstate, tok)
            pos += 1
            if self.flushes and pos >= self.seg_len:
                dstate = flush_segment(self.params, self.cfg, dstate)
                pos = 0
            tok = pick(logits)
            finite &= torch.isfinite(logits).all()
            out.append(tok)
        toks = torch.stack(out, dim=1).cpu().numpy()
        t_end = time.perf_counter()
        return GenerationResult(
            toks, P // self.seg_len, finite=bool(finite),
            ttft_s=t_first - t0,
            tok_s=B * max(max_new - 1, 0) / max(t_end - t_first, 1e-9))

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
