"""Serve-stack telemetry: a metrics registry and a chunk-granular trace.

Two halves, bundled by ``Telemetry`` and threaded through the engine, the
scheduler, the prefill pipeline and the state stores:

* ``MetricsRegistry``: labelled counters, gauges and histograms, plus
  *probes*, callables sampled at snapshot time (the engine registers its
  captured-program counts and its stores' stats this way, so a snapshot is
  current with no per-call bookkeeping). The process-wide registry
  (``default_registry``) also carries the process's CUDA graph captures
  (``core/capture.py``) and its kernel library build (``kernels/build.py``)
  as probes: the counterparts of the reference's XLA compile counter.

* ``TraceRecorder``: host-clock spans with per-request lanes, exported as
  Chrome-trace / Perfetto JSON. The scheduler emits spans for every decode
  chunk, admission window, admission round, segment flush, transplant,
  session restore and persist, prefix-cache probe and idle-drain round.
  ``itl_values`` / ``itl_percentiles`` (inter-token latencies off the
  per-chunk emit stamps) and ``admission_stall_s`` (the longest decode gap
  overlapping an admission window) are derived from it.

Telemetry is host-side only: nothing here reads a device tensor or
synchronizes the device. Span and metric arguments are host values the
scheduler already holds (slot mirrors, cursors, queue lengths), and the
device memory gauges read the caching allocator's counters, a host query.
With a recorder, each span also enters ``torch.profiler.record_function``
under its name, so a profiler trace of the same run shows the host spans
beside the kernels.

``python -m repro_torch.serve.telemetry trace.json`` validates a trace
(``_main``).
"""
from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["MetricsRegistry", "TraceRecorder", "Telemetry", "default_registry",
           "validate_chrome_trace", "SPAN_CATEGORIES"]


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

def _series_key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


HIST_WINDOW = 4096      # the most recent values a histogram's percentiles read


class _Hist:
    """One histogram series: count, sum and max over every value, and the
    last ``HIST_WINDOW`` values for the percentiles. Up to the window the
    summary is the one over all raw values."""

    def __init__(self):
        self.count, self.dropped_sum, self.max = 0, 0.0, -np.inf
        self.recent: Deque[float] = deque(maxlen=HIST_WINDOW)

    def add(self, v: float) -> None:
        if len(self.recent) == HIST_WINDOW:
            self.dropped_sum += self.recent[0]
        self.count += 1
        self.max = max(self.max, v)
        self.recent.append(v)

    def summary(self) -> Dict[str, float]:
        arr = np.asarray(self.recent, np.float64)
        total = self.dropped_sum + float(arr.sum())
        return {"count": self.count, "sum": total, "mean": total / self.count,
                "p50": float(np.percentile(arr, 50)), "p99": float(np.percentile(arr, 99)),
                "max": float(self.max)}


class MetricsRegistry:
    """Labelled counters, gauges and histograms with a JSON-able snapshot.

    Series are keyed ``name{label=value,...}``, so a snapshot is a flat,
    diffable dict. Histograms summarize to count/sum/mean/p50/p99/max at
    snapshot time: count, sum and max over every value, the percentiles
    over the last ``HIST_WINDOW`` (``_Hist``), so a long-lived process's
    registry and its snapshot's cost stay bounded. ``register_probe(name,
    fn)`` samples ``fn()`` at snapshot time under ``probes[name]``;
    ``register_reset_hook(fn)`` runs ``fn`` on ``reset()``."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, _Hist] = {}
        self._probes: Dict[str, Callable[[], Any]] = {}
        self._reset_hooks: List[Callable[[], None]] = []

    def inc(self, name: str, n: float = 1, **labels) -> None:
        k = _series_key(name, labels)
        self.counters[k] = self.counters.get(k, 0) + n

    def set_gauge(self, name: str, value: float, **labels) -> None:
        self.gauges[_series_key(name, labels)] = value

    def observe(self, name: str, value: float, **labels) -> None:
        k = _series_key(name, labels)
        if k not in self.histograms:
            self.histograms[k] = _Hist()
        self.histograms[k].add(float(value))

    def register_probe(self, name: str, fn: Callable[[], Any]) -> None:
        self._probes[name] = fn

    def register_reset_hook(self, fn: Callable[[], None]) -> None:
        if fn not in self._reset_hooks:
            self._reset_hooks.append(fn)

    def remove_series(self, name: str) -> None:
        """Drops every series of ``name`` (any labels) from all kinds."""
        for store in (self.counters, self.gauges, self.histograms):
            for k in [k for k in store if k == name or k.startswith(name + "{")]:
                del store[k]

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()
        for fn in self._reset_hooks:
            fn()

    def snapshot(self) -> Dict[str, Any]:
        """Counters and gauges as they are, histograms summarized, probes
        sampled now. A failing probe reads as an ``error`` string: a
        metrics read must not take the serve loop down."""
        probes = {}
        for name, fn in self._probes.items():
            try:
                probes[name] = fn()
            except Exception as e:           # a probe is outside code
                probes[name] = {"error": f"{type(e).__name__}: {e}"}
        return {"counters": dict(self.counters), "gauges": dict(self.gauges),
                "histograms": {k: h.summary() for k, h in self.histograms.items()},
                "probes": probes}


def _graph_captures() -> Dict[str, float]:
    from repro_torch.core import capture
    return {"total": capture.captures, "secs_total": capture.capture_seconds}


def _kernel_build() -> Dict[str, Any]:
    from repro_torch.kernels import build
    built = build.build_seconds is not None
    return {"builds_total": int(built), "secs_total": build.build_seconds or 0.0,
            "loaded": build.loaded()}


_DEFAULT: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-wide registry: engines default their ``Telemetry`` to it.
    It carries the process's CUDA graph captures and kernel library build
    as probes (``graph_captures``, ``kernel_build``). Tests that want
    isolation pass ``Telemetry(registry=MetricsRegistry())``."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MetricsRegistry()
        _DEFAULT.register_probe("graph_captures", _graph_captures)
        _DEFAULT.register_probe("kernel_build", _kernel_build)
    return _DEFAULT


# ---------------------------------------------------------------------------
# Trace recorder (Chrome trace / Perfetto)
# ---------------------------------------------------------------------------

# the categories the scheduler and engine emit; the schema check holds
# every event to them, so a misspelt category cannot vanish from queries
SPAN_CATEGORIES = ("decode", "admission", "prefill", "flush", "transplant", "session",
                   "cache", "idle", "generate", "emit")


@dataclass
class _Span:
    name: str
    cat: str
    t0: float                   # perf_counter seconds
    t1: float
    lane: Optional[str]         # None: the scheduler's lane
    args: Dict[str, Any] = field(default_factory=dict)


class _SpanCtx:
    """A span on the hot path: stamps the host clock and enters
    ``torch.profiler.record_function`` under the span's name, so a profiler
    trace shows the same interval beside the kernels."""

    __slots__ = ("rec", "name", "cat", "lane", "args", "t0", "_rf")

    def __init__(self, rec: "TraceRecorder", name: str, cat: str, lane: Optional[str],
                 args: Dict[str, Any]):
        self.rec, self.name, self.cat = rec, name, cat
        self.lane, self.args = lane, args

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self.t0 = time.perf_counter()
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        self.rec.spans.append(_Span(self.name, self.cat, self.t0, time.perf_counter(),
                                    self.lane, self.args))
        return False


class TraceRecorder:
    """Host-clock spans and instants with per-request lanes.

    Lanes map to Chrome-trace threads: lane None is the scheduler's own
    timeline (tid 0), every other lane (request ids, mostly) gets a tid and
    a ``thread_name`` record. ``emit(req_id, t, n)`` records one chunk's
    tokens of one request (every token of a chunk shares the chunk's host
    stamp); the per-token view exists only inside ``itl_values``."""

    def __init__(self, t0: Optional[float] = None):
        self.t0 = time.perf_counter() if t0 is None else t0
        self.spans: List[_Span] = []
        self.instants: List[_Span] = []
        self.emits: Dict[Any, List[Tuple[float, int]]] = {}

    def span(self, name: str, cat: str, lane: Optional[str] = None, **args):
        return _SpanCtx(self, name, cat, lane, args)

    def add_span(self, name: str, cat: str, t0: float, t1: float,
                 lane: Optional[str] = None, **args) -> None:
        """A span from host stamps taken before (an admission window)."""
        self.spans.append(_Span(name, cat, t0, t1, lane, args))

    def instant(self, name: str, cat: str, t: Optional[float] = None,
                lane: Optional[str] = None, **args) -> None:
        t = time.perf_counter() if t is None else t
        self.instants.append(_Span(name, cat, t, t, lane, args))

    def emit(self, req_id, t: float, n_tokens: int) -> None:
        self.emits.setdefault(req_id, []).append((t, n_tokens))
        self.instants.append(_Span("tokens", "emit", t, t, str(req_id), {"n": n_tokens}))

    def itl_values(self) -> List[float]:
        """Every request's inter-token latencies, pooled: a chunk of n
        tokens gives n - 1 zero gaps and one gap to the chunk before."""
        itls: List[float] = []
        for chunks in self.emits.values():
            prev_t = None
            for t, n in chunks:
                if prev_t is not None:
                    itls.append(t - prev_t)
                itls.extend([0.0] * (n - 1))
                prev_t = t
        return itls

    def itl_percentiles(self) -> Tuple[float, float]:
        """(p50, p99) of ``itl_values``; (0, 0) without any."""
        itls = self.itl_values()
        if not itls:
            return 0.0, 0.0
        return float(np.percentile(itls, 50)), float(np.percentile(itls, 99))

    def admission_windows(self) -> List[Tuple[float, float]]:
        return [(s.t0, s.t1) for s in self.spans if s.name == "admission"]

    def admission_stall_s(self) -> float:
        """The longest gap between two consecutive emit stamps (any
        request) that overlaps an admission window: the head-of-line stall
        an admission puts on the decoding slots. 0 without such a gap."""
        times = sorted({t for chunks in self.emits.values() for t, _ in chunks})
        gaps = list(zip(times, times[1:]))
        stall = 0.0
        for w0, w1 in self.admission_windows():
            for a, b in gaps:
                if a <= w1 and b >= w0:
                    stall = max(stall, b - a)
        return stall

    def span_totals(self) -> Dict[str, Dict[str, float]]:
        """{span name: {"count", "total_s"}} over the recorded spans."""
        out: Dict[str, Dict[str, float]] = {}
        for s in self.spans:
            row = out.setdefault(s.name, {"count": 0, "total_s": 0.0})
            row["count"] += 1
            row["total_s"] += s.t1 - s.t0
        return out

    def chrome_trace(self) -> Dict[str, Any]:
        """The timeline as a Chrome-trace object: times in microseconds
        from ``t0``; spans are complete ("X") events, instants "i"; lanes
        are named threads of pid 1."""
        lanes: Dict[Optional[str], int] = {None: 0}
        events: List[Dict[str, Any]] = [
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "repro_torch.serve"}},
            {"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
             "args": {"name": "scheduler"}},
        ]

        def tid(lane: Optional[str]) -> int:
            if lane not in lanes:
                lanes[lane] = len(lanes)
                events.append({"ph": "M", "pid": 1, "tid": lanes[lane], "name": "thread_name",
                               "args": {"name": f"req:{lane}"}})
            return lanes[lane]

        for s in self.spans:
            events.append({"ph": "X", "pid": 1, "tid": tid(s.lane), "name": s.name,
                           "cat": s.cat, "ts": (s.t0 - self.t0) * 1e6,
                           "dur": max((s.t1 - s.t0) * 1e6, 0.0), "args": s.args})
        for s in self.instants:
            events.append({"ph": "i", "pid": 1, "tid": tid(s.lane), "name": s.name,
                           "cat": s.cat, "s": "t", "ts": (s.t0 - self.t0) * 1e6,
                           "args": s.args})
        events.sort(key=lambda e: e.get("ts", -1.0))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.write("\n")


def validate_chrome_trace(trace: Any) -> List[str]:
    """Schema check of a trace (a path or a loaded object) -> the problems
    found, empty when it is valid: the envelope, each event's fields, the
    category of every X and i event, and a ``thread_name`` record for every
    tid used."""
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["top level must be an object with a 'traceEvents' list"]
    events = trace["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["'traceEvents' must be a non-empty list"]
    errs: List[str] = []
    named_tids, used_tids = set(), set()
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "M", "C"):
            errs.append(f"event {i}: unknown ph {ph!r}")
            continue
        for k in ("name", "pid", "tid"):
            if k not in e:
                errs.append(f"event {i} ({e.get('name')!r}): missing {k!r}")
        if ph == "M":
            if e.get("name") == "thread_name":
                named_tids.add((e.get("pid"), e.get("tid")))
            continue
        used_tids.add((e.get("pid"), e.get("tid")))
        if "ts" not in e:
            errs.append(f"event {i} ({e.get('name')!r}): missing 'ts'")
        elif not isinstance(e["ts"], (int, float)) or e["ts"] < 0:
            errs.append(f"event {i} ({e.get('name')!r}): bad ts {e['ts']!r}")
        if e.get("cat") not in SPAN_CATEGORIES:
            errs.append(f"event {i} ({e.get('name')!r}): unknown cat {e.get('cat')!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"event {i} ({e.get('name')!r}): bad dur {dur!r}")
    for t in sorted(used_tids - named_tids, key=str):
        errs.append(f"tid {t} used but never named via thread_name metadata")
    return errs


# ---------------------------------------------------------------------------
# Telemetry bundle
# ---------------------------------------------------------------------------

class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


class Telemetry:
    """A registry (metrics) and an optional trace recorder; every write is
    guarded, so a disabled instance costs a few attribute checks per chunk.

    * ``Telemetry()``: metrics into the process registry, no trace (the
      engine's default);
    * ``Telemetry(trace=True)``: also the span recorder;
    * ``Telemetry.disabled()``: everything off."""

    def __init__(self, *, metrics: bool = True, trace: bool = False,
                 registry: Optional[MetricsRegistry] = None):
        self.registry = (registry if registry is not None
                         else (default_registry() if metrics else None))
        self.trace: Optional[TraceRecorder] = TraceRecorder() if trace else None

    @classmethod
    def disabled(cls) -> "Telemetry":
        return cls(metrics=False, trace=False)

    @property
    def on(self) -> bool:
        return self.registry is not None or self.trace is not None

    def inc(self, name: str, n: float = 1, **labels) -> None:
        if self.registry is not None:
            self.registry.inc(name, n, **labels)

    def set_gauge(self, name: str, value: float, **labels) -> None:
        if self.registry is not None:
            self.registry.set_gauge(name, value, **labels)

    def observe(self, name: str, value: float, **labels) -> None:
        if self.registry is not None:
            self.registry.observe(name, value, **labels)

    def span(self, name: str, cat: str, lane: Optional[str] = None, **args):
        if self.trace is None:
            return _NULL
        return self.trace.span(name, cat, lane=lane, **args)

    def add_span(self, name: str, cat: str, t0: float, t1: float,
                 lane: Optional[str] = None, **args) -> None:
        if self.trace is not None:
            self.trace.add_span(name, cat, t0, t1, lane=lane, **args)

    def instant(self, name: str, cat: str, t: Optional[float] = None,
                lane: Optional[str] = None, **args) -> None:
        if self.trace is not None:
            self.trace.instant(name, cat, t=t, lane=lane, **args)

    def emit(self, req_id, t: float, n_tokens: int) -> None:
        if self.trace is not None:
            self.trace.emit(req_id, t, n_tokens)

    def sample_device_memory(self, device=None) -> None:
        """Chunk-boundary gauges of a CUDA device's memory
        (``device_bytes_in_use``, ``device_peak_bytes_in_use``: the caching
        allocator's counters, read on the host with no sync); nothing for
        the CPU."""
        if self.registry is None or device is None or torch.device(device).type != "cuda":
            return
        self.registry.set_gauge("device_bytes_in_use", torch.cuda.memory_allocated(device))
        self.registry.set_gauge("device_peak_bytes_in_use",
                                torch.cuda.max_memory_allocated(device))

    def snapshot(self) -> Optional[Dict[str, Any]]:
        return self.registry.snapshot() if self.registry is not None else None


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.serve.telemetry trace.json
# ---------------------------------------------------------------------------

def _main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Validate a Chrome-trace JSON written by "
                                             "TraceRecorder.export")
    ap.add_argument("trace", help="path to the trace JSON")
    ap.add_argument("--min-spans", type=int, default=1,
                    help="fail unless at least this many X spans exist")
    ap.add_argument("--require-cats", default="",
                    help="comma list of categories that must appear")
    args = ap.parse_args(argv)
    errs = validate_chrome_trace(args.trace)
    with open(args.trace) as f:
        obj = json.load(f)
    events = obj.get("traceEvents", []) if isinstance(obj, dict) else []
    spans = [e for e in events if isinstance(e, dict) and e.get("ph") == "X"]
    if len(spans) < args.min_spans:
        errs.append(f"only {len(spans)} spans, need >= {args.min_spans}")
    # instants count toward the categories (segment flushes are instants)
    cats = {e.get("cat") for e in events if isinstance(e, dict) and e.get("ph") in ("X", "i")}
    for c in filter(None, args.require_cats.split(",")):
        if c not in cats:
            errs.append(f"required category {c!r} absent (have {sorted(c for c in cats if c)})")
    if errs:
        for e in errs:
            print(f"TRACE-INVALID: {e}")
        return 1
    print(f"trace OK: {len(spans)} spans, {len(events)} events, "
          f"categories={sorted(c for c in cats if c)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
