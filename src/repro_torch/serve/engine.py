"""Serving engine: diagonal prefill, then greedy decode; ``serve`` is the
continuous-batching front door over many requests (``serve/scheduler.py``).

``generate(prompts [B, P], max_new)``:
  1. the prompt's full pieces of ``seg_len`` tokens run through
     ``forward_hidden`` under the diagonal schedule on the fused grouped
     cell (the kernels), in the model's segments;
  2. the final recurrent state (A, z; or h and the conv tail) moves into a
     fresh decode state (``_transplant``) and the prompt tail is fed through
     ``decode_step``, flushing at an ARMT segment boundary;
  3. greedy decode: one ``decode_step`` per token (for ARMT models its
     attention on the decode-attention kernel, with ``flush_segment`` when
     the in-segment position reaches seg_len; for Mamba models the scan on
     the mamba_scan kernel).

An ARMT model's seg_len is its segment. A pure-SSM model (falcon-mamba) has
no segment boundary: its seg_len is ``max_len``, the largest piece of a
prompt that goes through the diagonal prefill at once, which runs it in
segments of ``DEFAULT_SEG_LEN`` tokens; it never flushes.

Positions are tracked on the host: every ``decode_step`` advances the
state's position by exactly the tokens fed.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.memory import RECURRENT_KEYS
from repro_torch.models.model import (decode_state_init, decode_step,
                                      flush_segment, forward_hidden,
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


@dataclass
class GenerationResult:
    tokens: np.ndarray          # [B, max_new]
    prefill_segments: int
    finite: bool = True         # every logit the tokens were taken from was finite
    ttft_s: float = 0.0         # prefill wall time, ending in a device sync
    tok_s: float = 0.0          # decode tokens (all rows) per second after the first


class ServeEngine:
    """Constant-memory serving of one model: per layer the recurrent state
    (ARMT's A/z plus a current-segment cache of seg_len + M rows, or
    Mamba's h and conv tail).

    max_len: a pure-SSM model's piece of prompt per diagonal prefill (its
    seg_len); an ARMT model's seg_len is its segment.
    device: None means the CUDA device (raises without one); the CPU only
    when asked for."""

    def __init__(self, params: Dict, cfg: ArchConfig, *, device=None,
                 max_len: int = 8192):
        if cfg.armt is None and not cfg.is_recurrent:
            raise ValueError(f"{cfg.name}: constant-memory serving needs recurrent "
                             "layer state, but cfg.armt is None and not every layer "
                             "is an SSM layer")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.seg_len = cfg.armt.segment_len if cfg.armt is not None else max_len
        self.flushes = cfg.armt is not None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def prefill(self, prompts: torch.Tensor):
        """prompts: [B, P] -> (next-token logits [B, V] fp32, decode state,
        in-segment position)."""
        B, P = prompts.shape
        prompts = prompts.to(self.device)
        dstate = decode_state_init(self.cfg, B, dtype=self.params["embed"].dtype,
                                   device=self.device)
        n_full = P // self.seg_len
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

    def _prefill_full(self, toks: torch.Tensor):
        """The diagonal prefill of whole pieces in the model's segments; a
        length that is not a whole number of them ends in one shorter
        segment, run from the state the whole ones left (exact: the state is
        layer-local)."""
        seg, T = segment_len(self.cfg), toks.shape[1]
        cuts = [T] if T <= seg or T % seg == 0 else [T - T % seg, T]
        state, start = None, 0
        for end in cuts:
            hidden, state = forward_hidden(self.params, self.cfg, toks[:, start:end],
                                           schedule="diagonal", fused=True,
                                           state0=state)
            start = end
        return hidden, state

    def _chunk(self, dstate, toks: torch.Tensor, pos: int):
        """Feed a token chunk through ``decode_step`` in pieces that end at
        segment boundaries, flushing an ARMT model at each boundary."""
        logits = None
        t = 0
        while t < toks.shape[1]:
            take = min(self.seg_len - pos, toks.shape[1] - t)
            logits, dstate = decode_step(self.params, self.cfg, dstate,
                                         toks[:, t:t + take])
            pos += take
            t += take
            if self.flushes and pos >= self.seg_len:
                dstate = flush_segment(self.params, self.cfg, dstate)
                pos = 0
        return logits, dstate, pos

    @torch.no_grad()
    def generate(self, prompts, max_new: int) -> GenerationResult:
        """Greedy decode of max_new tokens after the prompt [B, P]."""
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long)
        t0 = time.perf_counter()
        logits, dstate, pos = self.prefill(prompts)
        tok = logits.argmax(-1)
        finite = torch.isfinite(logits).all()     # stays on the device until the end
        self._sync()
        t_first = time.perf_counter()
        out = [tok]
        for _ in range(max_new - 1):
            logits, dstate = decode_step(self.params, self.cfg, dstate, tok)
            pos += 1
            if self.flushes and pos >= self.seg_len:
                dstate = flush_segment(self.params, self.cfg, dstate)
                pos = 0
            tok = logits.argmax(-1)
            finite &= torch.isfinite(logits).all()
            out.append(tok)
        toks = torch.stack(out, dim=1).cpu().numpy()
        t_end = time.perf_counter()
        B = prompts.shape[0]
        return GenerationResult(
            toks, prompts.shape[1] // self.seg_len, finite=bool(finite),
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
