"""Continuous-batching scheduler: a fixed pool of decode slots fed from a
request queue, with interleaved (or blocking) admission.

Each slot is one batch row of a pooled decode state (the static state of the
engine's ``DecodeProgram`` of n_slots rows: its ``pos`` is an int64
[n_slots] vector) and owns that request's
recurrent state of every layer (ARMT memory A, z and the current-segment
KV cache; or Mamba's h and conv tail; in the engine's cache mode a KV cache
of ``max_len`` rows) and its position, so requests at different segment
phases decode together in one step.

A request is admitted by prefilling it alone at B = 1 and copying the
resulting decode state into a free slot's row; the other slots' rows are
not touched. Admission is interleaved by default: the request reserves a
slot and its prefill runs as a resumable pipeline
(``ServeEngine.start_prefill``) that advances ``prefill_groups_per_chunk``
band steps of its diagonal stage, or one tail piece, per decode chunk, so
a long prompt no longer stalls every decoding slot for its whole prefill.
Up to ``max_concurrent_admissions`` admissions are in flight (None: as
many as free slots), FIFO, in the engine's ``AdmissionPool``: each round
every one of them advances one unit ('round_robin'; same-signature
diagonal stages through one pooled band step), or only the oldest
('oldest_first'). ``prefill_groups_per_chunk=0`` blocks: the request is
prefilled whole (``ServeEngine.prefill``) between chunks, and so does an
engine whose schedule is not 'diagonal' in 'armt' mode (a cache-mode
prompt is tail pieces only, one piece). The finished state is installed
by the same ``_install`` either way, so the tokens are blocking
admission's. ``admission_byte_budget``: a prompt whose full-``ys`` prefill
would hold more device bytes at its peak (``ServeEngine.
prefill_activation_bytes``: the carry, the states and the band's
transients) goes through the streaming carry in stages that fit the
budget.

``fused_admission``: the reference runs the decode chunk and the round's
band steps as one jitted program. Here the chunk is CUDA graph replays and
the band steps eager launches, so it means an order: the chunk's replays
are enqueued first and the round's band steps right after them, both
before the chunk's one device-to-host read, so the host enqueues the
admission's launches while the card runs the chunk. A member admitted by
that round starts decoding with the next chunk, as in the reference's
fused program; when no member is at a diagonal stage the round runs in the
unfused order (admission work, then the chunk).

A decode chunk is ``chunk`` steps of the program's packed step over every
slot (a CUDA graph on the card, replayed per step), reading its static
``active`` mask: the rows of inactive slots keep every leaf bit for bit.
The program's masked flush, reading its static ``boundary`` mask, flushes
exactly the slots whose position reached ``seg_len`` (ARMT models in
'armt' mode only: a pure-SSM model has no segment boundary, and cache mode
none; their slots never flush). Both are applied masked whatever the
masks hold; a step in which no slot is active, and a flush no slot
reaches, are not replayed. In
cache mode a request whose prompt and new tokens exceed ``max_len`` is
rejected with ``invalid_request``. Which slots are active and which cross a boundary at
each step is known on the host from each slot's position and remaining
count (``_Slot.pos``, ``_Slot.remaining``): the arithmetic is the one the
device runs, so the host never reads a device value to decide. The masks
of a chunk go to the device once, and its tokens come back once, when the
chunk's events are streamed; slots are freed and requests admitted then.

Requests are pulled from the ``requests`` iterable lazily, between chunks.
With ``max_queue=None`` (the pull model) nothing is read from the source
until a slot can take it; a source may ``yield None`` for "nothing ready
yet". With ``max_queue`` set (the push model) the source is drained into a
bounded backlog, and overflow is rejected with a ``queue_full`` event.
Rejections are ``RequestError`` events on the stream; ``run`` does not
raise for a bad request.

Sessions (the engine's ``SessionStore``): a request whose ``session_id``
the store holds is admitted by resuming it, feeding only its pending
tokens and the new prompt from the stored state (blocking, or as the
pipeline's tail pieces); an evicted one is rejected with
``session_evicted``, and in cache mode one whose stored tokens, prompt
and max_new exceed max_len with ``invalid_request`` (as ``generate``
refuses it); an unknown one starts fresh. When such a request
finishes, its slot's row is copied out of the pool at that chunk's drain
(the row was frozen, bit for bit, at the step it finished) and stored with
the history. A slot's step consumes the token it emits, so nothing is
pending. With a prefix cache on the engine, an admission prefills only the
segments after its longest cached prefix.

Telemetry (the engine's ``Telemetry``): spans per decode chunk (around its
one device-to-host transfer), admission round, admission window,
transplant, session restore and persist, and idle-drain round, an instant
per segment flush (from the host's position mirror), per-chunk emit stamps
and occupancy metrics; all from host values, with no device read of its
own.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.serve.state_store import SessionEvicted


@dataclass
class Request:
    """One generation request. prompt: int [P] token ids (P >= 1).
    session_id: resume or start this conversation in the engine's session
    store; the prompt is then this turn's new tokens only."""
    req_id: Union[int, str]
    prompt: np.ndarray
    max_new: int
    session_id: Optional[str] = None


@dataclass
class StreamEvent:
    """One generated token, streamed when its chunk reaches the host.

    Host-clock metrics, chunk-granular: ttft_s (from submission, queue wait
    included), queue_wait_s and concurrent_admissions (admissions in flight
    when this one started, its own included) on the first and final
    events; tok_s (tokens over the time since admission) and finite (every
    logit this request's tokens were taken from was finite) on the final
    event; t_emit on every event."""
    req_id: Union[int, str]
    token: int
    index: int                  # 0-based position within the request's output
    done: bool                  # True on the request's final token
    ttft_s: Optional[float] = None
    tok_s: Optional[float] = None
    t_emit: Optional[float] = None
    queue_wait_s: Optional[float] = None
    finite: Optional[bool] = None
    concurrent_admissions: Optional[int] = None


@dataclass
class RequestError:
    """Structured rejection streamed in-band. code: 'invalid_request' |
    'queue_full' | 'session_evicted'."""
    req_id: Union[int, str]
    code: str
    message: str


@dataclass
class _Slot:
    req_id: Optional[Union[int, str]] = None
    remaining: int = 0
    index: int = 0
    active: bool = False
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: Optional[float] = None
    n_concurrent: int = 1
    tokens: list = field(default_factory=list)
    session_id: Optional[str] = None
    prompt: Optional[np.ndarray] = None
    history: Optional[np.ndarray] = None    # a resumed session's earlier turns
    # host mirror of the slot's in-segment position: seeded by the
    # admission, one step per emitted token, reset at seg_len, as
    # decode_step and the masked flush_segment move it on the device
    pos: int = 0


@dataclass
class _Admission:
    """An interleaved admission in flight: its suspended pipeline, the slot
    it reserved and what the install needs."""
    req: Request
    slot: int
    pipe: object                 # serve.engine.PrefillPipeline
    entry: object                # the resumed SessionEntry, or None
    t_submit: float
    t_admit: float
    n_concurrent: int = 1


FAIRNESS = ("round_robin", "oldest_first")


def _host(t: torch.Tensor) -> np.ndarray:
    """The scheduler's one device-to-host transfer per chunk."""
    return t.cpu().numpy()


class ContinuousScheduler:
    """Drives a ServeEngine over many requests with continuous batching
    (the arguments are ``ServeEngine.serve``'s)."""

    def __init__(self, engine, *, n_slots: int = 4, chunk: int = 8,
                 max_queue: Optional[int] = None, prefill_groups_per_chunk: int = 4,
                 fused_admission: bool = False,
                 max_concurrent_admissions: Optional[int] = None,
                 admission_fairness: str = "round_robin",
                 admission_byte_budget: Optional[int] = None):
        from repro_torch.serve.engine import AdmissionPool   # it imports this module
        if n_slots < 1 or chunk < 1:
            raise ValueError(f"n_slots {n_slots} and chunk {chunk} must be >= 1")
        if prefill_groups_per_chunk < -1:
            raise ValueError("prefill_groups_per_chunk must be >= -1 (-1 a whole stage "
                             f"per chunk, 0 blocking), got {prefill_groups_per_chunk}")
        if max_concurrent_admissions is not None and max_concurrent_admissions < 1:
            raise ValueError("max_concurrent_admissions must be >= 1 or None, got "
                             f"{max_concurrent_admissions}")
        if admission_fairness not in FAIRNESS:
            raise ValueError(f"admission_fairness must be one of {FAIRNESS}, got "
                             f"{admission_fairness!r}")
        if admission_byte_budget is not None and admission_byte_budget <= 0:
            raise ValueError(f"admission_byte_budget must be > 0 or None, got "
                             f"{admission_byte_budget}")
        self.engine = engine
        self.n_slots = n_slots
        self.chunk = chunk
        self.max_queue = max_queue
        self.prefill_groups_per_chunk = prefill_groups_per_chunk
        self.fused_admission = fused_admission
        self.max_concurrent_admissions = max_concurrent_admissions
        self.admission_fairness = admission_fairness
        self.admission_byte_budget = admission_byte_budget
        self._adms: list = []                # FIFO
        self._pool_adm = AdmissionPool(engine)
        # rounds run by the loop that drains admissions while no slot decodes
        self.idle_drain_rounds = 0
        # (t_start, t_end) of every completed admission, host clock
        self.admission_windows: list = []
        self.prog = engine.program(n_slots, "serve")
        self.prog.prepare()                 # capture before any slot holds data
        self.pool = self.prog.state
        self.tok = self.prog.tok            # each slot's next input
        self.finite = self.prog.finite
        self.tok.zero_()
        self.finite.fill_(True)
        self.slots = [_Slot() for _ in range(n_slots)]
        self.free: deque = deque(range(n_slots))

    @property
    def tel(self):
        """The engine's telemetry, read at each use (a caller may swap it
        between serve calls)."""
        return self.engine.telemetry

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------

    def _validate(self, req: Request) -> Optional[RequestError]:
        prompt = np.asarray(req.prompt)
        if req.max_new < 1:
            return RequestError(req.req_id, "invalid_request",
                                f"max_new must be >= 1, got {req.max_new}")
        if prompt.ndim != 1 or prompt.shape[0] < 1:
            return RequestError(req.req_id, "invalid_request",
                                f"prompt must be a [P>=1] id vector, got "
                                f"shape {prompt.shape}")
        if (self.engine.serve_mode == "cache"
                and prompt.shape[0] + req.max_new > self.engine.max_len):
            return RequestError(req.req_id, "invalid_request",
                                f"prompt+max_new exceeds max_len {self.engine.max_len} "
                                "of the KV cache")
        if req.session_id is not None and self.engine.session_store is None:
            return RequestError(req.req_id, "invalid_request",
                                "request carries a session_id but the "
                                "engine has no session_store")
        return None

    def _session(self, req: Request):
        """(the stored session entry or None, a RequestError or None) of a
        request: an evicted session is a ``session_evicted`` rejection, and
        in cache mode a turn that does not fit the KV cache after the
        session's stored tokens an ``invalid_request`` one."""
        if req.session_id is None:
            return None, None
        try:
            entry = self.engine.session_store.get(req.session_id)
        except SessionEvicted as e:
            return None, RequestError(req.req_id, "session_evicted", str(e))
        err = self.engine.session_len_error(entry, len(req.prompt), req.max_new)
        if err is not None:
            return None, RequestError(req.req_id, "invalid_request", err)
        return entry, None

    def _admission_plan(self, prompt_len: int):
        """The byte budget's decision for a prompt of ``prompt_len`` tokens:
        (stream, max_stage_segments). A prompt whose full-``ys`` prefill
        fits the budget keeps the default path; a larger one streams, in
        stages halved until one fits. Host arithmetic only."""
        budget = self.admission_byte_budget
        if budget is None:
            return False, None
        eng = self.engine
        S = prompt_len // eng.seg_len
        if S < 2 or eng.prefill_activation_bytes(S, stream=False) <= budget:
            return False, None
        max_g = S
        while max_g > 1 and eng.prefill_activation_bytes(max_g, stream=True) > budget:
            max_g //= 2
        self.tel.inc("overflow_admissions_total")
        self.tel.set_gauge("admission_stage_cap_segments", max_g)
        return True, (max_g if max_g < S else None)

    @torch.no_grad()
    def _admit(self, req: Request, t_submit: float) -> Optional[RequestError]:
        """Prefill the request alone (B = 1) and install it in a free slot;
        other slots' rows are untouched. Returns a RequestError instead of
        admitting when the request is rejected."""
        err = self._validate(req)
        if err is not None:
            return err
        t_admit = time.perf_counter()
        prompt = np.asarray(req.prompt)
        entry, err = self._session(req)
        if err is not None:
            return err
        slot = self.free.popleft()
        eng = self.engine
        if entry is not None:
            # resume: the stored state, then pending + this turn's tokens
            with self.tel.span("session_restore", "session", lane=str(req.req_id),
                               session=req.session_id):
                logits, one_state, pos = eng.resume(entry, prompt)
        else:
            stream, max_g = self._admission_plan(prompt.shape[0])
            if stream:
                # over the byte budget: the streaming pipeline, drained here
                pipe = eng.start_prefill(prompt[None], groups_per_call=None,
                                         stream=True, max_stage_segments=max_g)
                while not pipe.advance():
                    pass
                logits, one_state, pos, _ = pipe.result()
            else:
                logits, one_state, pos, _ = eng.prefill(
                    torch.as_tensor(prompt, dtype=torch.long)[None])
        self._install(slot, req, entry, logits, one_state, pos, t_submit, t_admit)
        return None

    def _interleave(self) -> bool:
        """Interleaved admission needs the diagonal pipeline for segment
        stages; a cache-mode admission is tail pieces only. Anything else
        blocks."""
        if self.prefill_groups_per_chunk == 0:
            return False
        eng = self.engine
        return eng.schedule == "diagonal" or eng.serve_mode != "armt"

    def _can_admit(self) -> bool:
        """Room for another admission to start (the caller checks for a
        free slot): blocking admissions finish at once and are never
        capped; interleaved ones are, by max_concurrent_admissions."""
        return (self.max_concurrent_admissions is None
                or len(self._adms) < self.max_concurrent_admissions)

    @torch.no_grad()
    def _start(self, req: Request, t_submit: float) -> Optional[RequestError]:
        """Begin serving ``req``: blocking admission when interleaving is
        off or unavailable, else reserve a slot and add the request's
        pipeline to the admission pool. Returns a RequestError instead of
        starting when the request is rejected."""
        if not self._interleave():
            return self._admit(req, t_submit)
        err = self._validate(req)
        if err is not None:
            return err
        t_admit = time.perf_counter()
        prompt = np.asarray(req.prompt)
        entry, err = self._session(req)
        if err is not None:
            return err
        slot = self.free.popleft()
        k = self.prefill_groups_per_chunk
        stream, max_g = (self._admission_plan(prompt.shape[0]) if entry is None
                         else (False, None))
        pipe = self.engine.start_prefill(prompt[None], groups_per_call=None if k < 0 else k,
                                         session_entry=entry, stream=stream,
                                         max_stage_segments=max_g)
        self._adms.append(_Admission(req, slot, pipe, entry, t_submit, t_admit,
                                     n_concurrent=len(self._adms) + 1))
        self._pool_adm.add(pipe)
        return None

    def _finish_admissions(self, done_pipes) -> None:
        """Install each completed pipeline's state into its reserved slot,
        FIFO (from here as blocking admission)."""
        for pipe in done_pipes:
            adm = next(a for a in self._adms if a.pipe is pipe)
            logits, one_state, pos, _ = pipe.result()
            self._install(adm.slot, adm.req, adm.entry, logits, one_state, pos,
                          adm.t_submit, adm.t_admit, adm.n_concurrent)
            self._adms.remove(adm)

    @torch.no_grad()
    def _advance_admissions(self):
        """One round over the admissions in flight: each advances one unit
        (the pool's round, or only the oldest). With ``fused_admission``,
        decoding slots and a member at a diagonal stage, the decode chunk
        is enqueued first and the band steps right after it. Completed
        admissions are installed FIFO. -> (chunk tokens, emit mask) when
        this round ran the chunk, else (None, None)."""
        with self.tel.span("admission_round", "admission", n_adms=len(self._adms),
                           fused=self.fused_admission):
            return self._advance_admissions_inner()

    def _advance_admissions_inner(self):
        toks = active = None
        run_fused = self.fused_admission and any(s.active for s in self.slots)
        if self.admission_fairness == "oldest_first" and len(self._adms) > 1:
            done = self._pool_adm.advance_oldest()
        else:
            if run_fused and self._pool_adm.diag_buckets():
                toks, active = self._run_chunk()
            done = self._pool_adm.advance_round()
        self._finish_admissions(done)
        return toks, active

    def _install(self, slot: int, req: Request, entry, logits, one_state, pos: int,
                 t_submit: float, t_admit: float, n_concurrent: int = 1) -> None:
        """Copy a B = 1 decode state into row ``slot`` of the pool, in place,
        with its first token and position: the one completion path of
        blocking and interleaved admission."""
        with self.tel.span("transplant", "transplant", lane=str(req.req_id), slot=slot):
            for axis, part in ((0, "prelude"), (1, "pattern")):
                for dst, src in zip(self.pool[part], one_state[part]):
                    for k, leaf in dst.items():
                        leaf.select(axis, slot).copy_(src[k].select(axis, 0))
            self.pool["pos"][slot] = pos
            self.tok[slot] = logits[0].argmax(-1)
            self.finite[slot] = torch.isfinite(logits).all()
        s = self.slots[slot]
        s.req_id, s.remaining, s.index, s.active = req.req_id, req.max_new, 0, True
        s.t_submit, s.t_admit, s.t_first = t_submit, t_admit, None
        s.n_concurrent = n_concurrent
        s.pos = int(pos)
        s.tokens, s.session_id, s.prompt = [], req.session_id, np.asarray(req.prompt)
        s.history = entry.tokens if entry is not None else np.empty(0, np.int32)
        t_end = time.perf_counter()
        self.admission_windows.append((t_admit, t_end))
        # the whole admission window, start to transplant, on the request's lane
        self.tel.add_span("admission", "admission", t_admit, t_end, lane=str(req.req_id),
                          slot=slot, queue_wait_s=t_admit - t_submit, concurrent=n_concurrent)
        self.tel.inc("admissions_total")
        self.tel.observe("queue_wait_s", t_admit - t_submit)
        self.tel.observe("admission_window_s", t_end - t_admit)

    def _persist_session(self, b: int) -> None:
        """A finished session's slot: its row, frozen at the step it finished,
        copied out of the pool and stored with the history, its position
        from the host mirror. The slot consumed every token it emitted, so
        nothing is pending."""
        s = self.slots[b]
        with self.tel.span("session_persist", "session", lane=str(s.req_id),
                           session=s.session_id):
            row = {part: tuple({k: leaf.narrow(axis, b, 1).clone() for k, leaf in tree.items()}
                               for tree in self.pool[part])
                   for axis, part in ((0, "prelude"), (1, "pattern"))}
            history = np.concatenate([s.history, s.prompt,
                                      np.asarray(s.tokens, np.int32)]).astype(np.int32)
            self.engine.session_store.put(s.session_id, state=row, pos=s.pos,
                                          pending=np.empty(0, np.int32), tokens=history)

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def _plan_chunk(self):
        """Host masks of the next chunk, [chunk, n_slots] each: which slots
        decode at each step, and which of those reach seg_len and flush."""
        seg_len = self.engine.seg_len
        active = np.zeros((self.chunk, self.n_slots), bool)
        boundary = np.zeros((self.chunk, self.n_slots), bool)
        for b, s in enumerate(self.slots):
            if not s.active:
                continue
            pos = s.pos
            for t in range(min(self.chunk, s.remaining)):
                active[t, b] = True
                pos += 1
                if self.engine.flushes and pos >= seg_len:
                    boundary[t, b] = True
                    pos = 0
        return active, boundary

    @torch.no_grad()
    def _run_chunk(self):
        """``chunk`` greedy steps of the packed decode over every slot ->
        (the step inputs [chunk, n_slots] on the device, the emit mask on
        the host). A step in which no slot is active changes nothing and is
        skipped."""
        prog = self.prog
        active, boundary = self._plan_chunk()
        masks = torch.from_numpy(np.stack([active, boundary]))
        if self.engine.device.type == "cuda":
            # from pinned memory, asynchronously: the host goes on to the
            # replays without waiting for the work queued before them (an
            # admission's band steps)
            masks = masks.pin_memory().to(self.engine.device, non_blocking=True)
        else:
            masks = masks.to(self.engine.device)
        toks = torch.empty(self.chunk, self.n_slots, dtype=torch.long,
                           device=self.engine.device)
        with torch.profiler.record_function("serve.decode_chunk"):
            for t in range(self.chunk):
                toks[t] = self.tok
                if not active[t].any():
                    continue
                prog.active.copy_(masks[0, t])
                prog.step()
                if boundary[t].any():
                    prog.boundary.copy_(masks[1, t])
                    prog.flush()
        return toks, active

    def _drain_chunk(self, toks, active) -> Iterator[StreamEvent]:
        """Bring one chunk's tokens (and the slots' finite flags) to the host
        in one transfer and stream their events. The telemetry rides on
        it: the ``decode_chunk`` span brackets that transfer (the wait for
        the chunk and the copy), and the emit stamps and occupancy metrics
        come from the host copies and the host masks."""
        tel = self.tel
        n_active = sum(s.active for s in self.slots)
        with tel.span("decode_chunk", "decode", steps=self.chunk, active_slots=n_active):
            host = _host(torch.cat([toks, self.finite[None].long()]))
        toks_np, finite = host[:-1], host[-1].astype(bool)
        now = time.perf_counter()
        if tel.trace is not None:
            for b, s in enumerate(self.slots):
                n = int(active[:, b].sum())
                if s.active and n:
                    tel.emit(s.req_id, now, n)
        tel.observe("chunk_active_slots", n_active)
        tel.observe("chunk_admissions_in_flight", len(self._adms))
        tel.set_gauge("pool_occupancy", self.n_slots - len(self.free))
        tel.sample_device_memory(self.engine.device)
        seg_len = self.engine.seg_len
        for t in range(self.chunk):
            for b, s in enumerate(self.slots):
                if not active[t, b] or not s.active:
                    continue
                s.remaining -= 1
                done = s.remaining == 0
                tok = int(toks_np[t, b])
                s.tokens.append(tok)
                # the emitted token was the step's input: pos moved by one,
                # and the chunk flushed an ARMT slot when it reached seg_len
                s.pos += 1
                if self.engine.flushes and s.pos >= seg_len:
                    s.pos = 0
                    tel.instant("segment_flush", "flush", t=now, lane=str(s.req_id))
                    tel.inc("decode_flushes_total")
                first = s.t_first is None
                if first:
                    s.t_first = now
                ev = StreamEvent(s.req_id, tok, s.index, done, t_emit=now)
                if first or done:
                    ev.queue_wait_s = s.t_admit - s.t_submit
                    ev.concurrent_admissions = s.n_concurrent
                if first:
                    ev.ttft_s = now - s.t_submit
                if done:
                    ev.ttft_s = s.t_first - s.t_submit
                    ev.tok_s = (s.index + 1) / max(now - s.t_admit, 1e-9)
                    ev.finite = bool(finite[b])
                yield ev
                s.index += 1
                if done:
                    s.active = False
                    if s.session_id is not None and self.engine.session_store is not None:
                        self._persist_session(b)
                    self.free.append(b)

    # ------------------------------------------------------------------
    # Driver
    # ------------------------------------------------------------------

    def run(self, requests: Iterable[Request]) -> Iterator[
            Union[StreamEvent, RequestError]]:
        """Generator: pulls requests lazily, admits them as slots free up
        (interleaving their prefills with decode chunks unless
        ``prefill_groups_per_chunk=0``), and yields one StreamEvent per
        generated token (chunk-granular latency) plus a RequestError for
        each rejected request."""
        it = iter(requests)
        exhausted = False

        def pull() -> Optional[Request]:
            # None when the source is exhausted or yielded None ("nothing
            # ready yet"); `exhausted` tells the two apart
            nonlocal exhausted
            if exhausted:
                return None
            try:
                return next(it)
            except StopIteration:
                exhausted = True
                return None

        queue: deque = deque()           # (request, t_submit at pull)
        while True:
            while self.free and queue and self._can_admit():
                req, t_sub = queue.popleft()
                err = self._start(req, t_sub)
                if err is not None:
                    yield err
            while not exhausted:
                can_start = bool(self.free) and not queue and self._can_admit()
                if not can_start and self.max_queue is None:
                    break                # pull model: backpressure by not pulling
                if (not can_start and self.max_queue is not None
                        and len(queue) >= self.max_queue + len(self.free)):
                    req = pull()
                    if req is None:
                        break
                    yield RequestError(
                        req.req_id, "queue_full",
                        f"all {self.n_slots} slots busy or spoken for and queue "
                        f"limit {self.max_queue} reached")
                    continue
                req = pull()
                if req is None:
                    break
                t_sub = time.perf_counter()
                if can_start:
                    err = self._start(req, t_sub)
                    if err is not None:
                        yield err
                else:
                    queue.append((req, t_sub))

            # one round over the admissions in flight, then the decode
            # chunk (unless the fused round ran it)
            toks = active = None
            if self._adms:
                toks, active = self._advance_admissions()
            if toks is None and any(s.active for s in self.slots):
                toks, active = self._run_chunk()
            if toks is not None:
                self.tel.observe("chunk_queue_depth", len(queue))
                yield from self._drain_chunk(toks, active)
            elif self._adms:
                # no slot decodes, so there is no chunk to interleave with:
                # drain the admissions until one lands or a new request
                # could start
                while (self._adms and not any(s.active for s in self.slots)
                       and not (self.free and self._can_admit()
                                and (queue or not exhausted))):
                    with self.tel.span("idle_drain_round", "idle", pending=len(self._adms)):
                        self._advance_admissions()
                    self.idle_drain_rounds += 1
            elif not queue and exhausted:
                return
            elif not queue:
                time.sleep(1e-3)         # a live source with nothing ready
