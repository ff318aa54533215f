"""The port's serve-stack telemetry (``serve/telemetry.py``) against the JAX
reference's (llama-1b-armt smoke config, fp32, CPU; the reference's own
tests use h2o-danube): the registry's semantics and snapshots, the Chrome
trace and its schema check, the CLI gate, the serving metrics derived from
the recorder (inter-token latencies, admission stall) against the
per-token events, a live serve run's span names and categories and
counters beside the reference's on the same requests, the one
device-to-host transfer per decode chunk with telemetry on, the engine's
probes and ``GenerationResult.metrics``, and telemetry off being a no-op
that leaves the events as they were. The reference engines are built with
``bucket_prompts=False`` (the port does not bucket prompts)."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import ContinuousScheduler as JScheduler  # noqa: E402
from repro.serve import MetricsRegistry as JRegistry  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import Telemetry as JTelemetry  # noqa: E402
from repro.serve import TraceRecorder as JRecorder  # noqa: E402
from repro.serve import validate_chrome_trace as j_validate  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, MetricsRegistry, PrefixCache,  # noqa: E402
                               Request, ServeEngine, Telemetry, TraceRecorder,
                               default_registry, validate_chrome_trace)
from repro_torch.serve import scheduler as sched_mod  # noqa: E402
from repro_torch.serve.telemetry import HIST_WINDOW, SPAN_CATEGORIES, _main as telemetry_cli  # noqa: E402

ARCH = "llama-1b-armt"
MAX_LEN = 256


@pytest.fixture(scope="module")
def setup():
    jc, tc = j_smoke(ARCH), t_smoke(ARCH)
    jp = jax.jit(lambda key: jmodel.init_params(jc, key))(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _toks(n, seed):
    return np.random.default_rng(seed).integers(8, 256, (n,)).astype(np.int32)


def _reqs(lens, max_new, seed=0):
    return [(f"r{i}", _toks(n, seed + i), max_new) for i, n in enumerate(lens)]


_JIT_ATTRS = ("_step", "_flush", "_loops", "_sched_fns", "_pipe_steps", "_fused_fns",
              "_pool_steps")
_FIRST = {}


def _jengine(jp, jc, **kw):
    """A reference engine (armt mode, MAX_LEN, ``bucket_prompts=False``)
    sharing its jitted programs with the module's first one, so each
    program compiles once (as ``tests/test_torch_state_store.py``'s)."""
    eng = JEngine(jp, jc, serve_mode="armt", max_len=MAX_LEN, bucket_prompts=False, **kw)
    first = _FIRST.setdefault(jc.name, eng)
    for attr in _JIT_ATTRS:
        setattr(eng, attr, getattr(first, attr))
    return eng


def _engines(setup, **kw):
    """(reference, port) engines, each with a trace recorder and a registry
    of its own."""
    jc, tc, jp, tp = setup
    return (_jengine(jp, jc, telemetry=JTelemetry(trace=True, registry=JRegistry()), **kw),
            ServeEngine(tp, tc, device="cpu", max_len=MAX_LEN,
                        telemetry=Telemetry(trace=True, registry=MetricsRegistry()), **kw))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def _registry_ops(reg):
    reg.inc("reqs_total")
    reg.inc("reqs_total", 2)
    reg.inc("reqs_total", result="hit")
    reg.inc("reqs_total", result="hit")
    reg.inc("reqs_total", result="miss")
    reg.set_gauge("occupancy", 3)
    reg.set_gauge("occupancy", 5)
    for v in (1.0, 2.0, 3.0, 4.0):
        reg.observe("wait_s", v)
    reg.observe("wait_s", 9.0, slot=1)


def test_registry_snapshot_equals_reference():
    """Counters, gauges (overwritten), labelled series and histogram
    summaries: the reference's snapshot after the same writes, JSON-able."""
    got, want = MetricsRegistry(), JRegistry()
    _registry_ops(got)
    _registry_ops(want)
    snap = got.snapshot()
    assert snap == want.snapshot()
    assert snap["counters"]["reqs_total"] == 3
    assert snap["counters"]["reqs_total{result=hit}"] == 2
    assert snap["gauges"]["occupancy"] == 5
    assert snap["histograms"]["wait_s"]["p50"] == 2.5
    json.dumps(snap)


def test_registry_histogram_window_is_bounded():
    """A histogram keeps only the last HIST_WINDOW values: count, sum, mean
    and max stay over every value, the percentiles read the window."""
    reg = MetricsRegistry()
    vals = np.random.default_rng(0).random(HIST_WINDOW + 1000) * 10
    vals[7] = 100.0                                    # the max, long out of the window
    for v in vals:
        reg.observe("lat_s", v)
    assert len(reg.histograms["lat_s"].recent) == HIST_WINDOW
    snap = reg.snapshot()["histograms"]["lat_s"]
    recent = vals[-HIST_WINDOW:]
    assert snap["count"] == len(vals) and snap["max"] == 100.0
    assert snap["sum"] == pytest.approx(vals.sum(), rel=1e-12)
    assert snap["mean"] == pytest.approx(vals.mean(), rel=1e-12)
    assert snap["p50"] == float(np.percentile(recent, 50))
    assert snap["p99"] == float(np.percentile(recent, 99))


def test_registry_reset_hooks():
    reg = MetricsRegistry()
    reg.inc("other")
    fired = []

    def hook():
        fired.append(1)
    reg.register_reset_hook(hook)
    reg.register_reset_hook(hook)                      # once by identity
    reg.reset()
    assert reg.counters == {} and fired == [1]


def test_registry_probes_sampled_at_snapshot():
    reg = MetricsRegistry()
    state = {"n": 0}
    reg.register_probe("live", lambda: state["n"])
    reg.register_probe("broken", lambda: 1 / 0)
    state["n"] = 7
    snap = reg.snapshot()
    assert snap["probes"]["live"] == 7
    assert "ZeroDivisionError" in snap["probes"]["broken"]["error"]


def test_default_registry_carries_graph_captures_and_the_kernel_build():
    """The counterparts of the reference's XLA compile counter: the
    process's CUDA graph captures and kernel library build, as probes (on
    the CPU nothing is captured or built)."""
    probes = default_registry().snapshot()["probes"]
    assert probes["graph_captures"] == {"total": 0, "secs_total": 0.0}
    assert probes["kernel_build"] == {"builds_total": 0, "secs_total": 0.0, "loaded": False}
    assert default_registry() is default_registry()


# ---------------------------------------------------------------------------
# Trace, schema, CLI
# ---------------------------------------------------------------------------

def _record(rec):
    with rec.span("decode_chunk", "decode", steps=4):
        pass
    rec.add_span("admission", "admission", 0.1, 0.2, lane="r0", slot=1)
    rec.instant("segment_flush", "flush", t=0.15, lane="r0")
    rec.emit("r0", 0.2, 3)


def test_chrome_trace_schema_valid_and_lanes():
    """A recorder's trace passes both packages' schema checks, names every
    lane, and carries the reference's events (the open span's clock
    aside)."""
    got, want = TraceRecorder(t0=0.0), JRecorder(t0=0.0)
    _record(got)
    _record(want)
    trace = got.chrome_trace()
    assert validate_chrome_trace(trace) == [] and j_validate(trace) == []
    names = {e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"scheduler", "req:r0"} <= names
    assert all(e.get("cat") in SPAN_CATEGORIES
               for e in trace["traceEvents"] if e["ph"] in ("X", "i"))

    def strip(t):
        return [(e["ph"], e["name"], e.get("cat"), e["tid"], e.get("args"))
                for e in t["traceEvents"] if e["name"] != "process_name"]
    assert sorted(map(repr, strip(trace))) == sorted(map(repr, strip(want.chrome_trace())))


def test_chrome_trace_schema_rejects_malformed():
    bad = {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 0, "name": "x", "cat": "decode", "ts": 0.0, "dur": -1.0},
        {"ph": "i", "pid": 1, "tid": 0, "name": "y", "cat": "not-a-cat", "ts": 1.0},
        {"ph": "Z", "pid": 1, "tid": 0, "name": "z"},
    ]}
    errs = validate_chrome_trace(bad)
    assert errs == j_validate(bad)
    assert any("dur" in e for e in errs) and any("not-a-cat" in e for e in errs)
    assert any("ph" in e for e in errs) and any("thread_name" in e for e in errs)
    assert validate_chrome_trace({"nope": 1}) and validate_chrome_trace({"traceEvents": []})


def test_telemetry_cli_gate(tmp_path):
    rec = TraceRecorder(t0=0.0)
    with rec.span("decode_chunk", "decode"):
        pass
    rec.instant("segment_flush", "flush", t=0.1)
    path = str(tmp_path / "trace.json")
    rec.export(path)
    assert telemetry_cli([path, "--require-cats", "decode,flush"]) == 0
    assert telemetry_cli([path, "--require-cats", "decode,session"]) == 1
    assert telemetry_cli([path, "--min-spans", "5"]) == 1


# ---------------------------------------------------------------------------
# Derived serving metrics
# ---------------------------------------------------------------------------

def _ref_itl(emit_times):
    itls = [b - a for ts in emit_times.values() for a, b in zip(ts, ts[1:])]
    if not itls:
        return 0.0, 0.0
    return float(np.percentile(itls, 50)), float(np.percentile(itls, 99))


def _ref_stall(windows, emit_times):
    times = sorted({t for ts in emit_times.values() for t in ts})
    stall = 0.0
    for w0, w1 in windows:
        for a, b in zip(times, times[1:]):
            if a <= w1 and b >= w0:
                stall = max(stall, b - a)
    return stall


def test_derivations_match_reference_synthetic():
    chunks = {"a": [(0.00, 3), (0.10, 3), (0.50, 2)], "b": [(0.05, 1), (0.60, 4)],
              "c": [(0.70, 1)]}
    windows = [(0.08, 0.45), (0.55, 0.58)]
    got, want = TraceRecorder(t0=0.0), JRecorder(t0=0.0)
    for rec in (got, want):
        for rid, cs in chunks.items():
            for t, n in cs:
                rec.emit(rid, t, n)
        for w0, w1 in windows:
            rec.add_span("admission", "admission", w0, w1)
    emit_times = {rid: [t for t, n in cs for _ in range(n)] for rid, cs in chunks.items()}
    assert got.itl_values() == want.itl_values()
    assert got.itl_percentiles() == want.itl_percentiles() == _ref_itl(emit_times)
    assert got.admission_stall_s() == want.admission_stall_s() == pytest.approx(
        _ref_stall(windows, emit_times))
    assert got.admission_windows() == windows


def test_derivations_match_events_live_run(setup):
    """A real serve run: the recorder's ITL percentiles and admission stall
    equal the derivations from each event's t_emit and the scheduler's
    admission windows, which are the recorder's."""
    seg = setup[1].armt.segment_len
    _, teng = _engines(setup)
    sched = ContinuousScheduler(teng, n_slots=2, chunk=4, max_concurrent_admissions=2)
    emit_times = {}
    for ev in sched.run([Request(*r) for r in _reqs([seg, seg + seg // 2, seg, seg + seg // 2,
                                                     seg], 10)]):
        emit_times.setdefault(ev.req_id, []).append(ev.t_emit)
    rec = teng.telemetry.trace
    assert rec.itl_percentiles() == _ref_itl(emit_times)
    assert rec.admission_stall_s() == pytest.approx(
        _ref_stall(sched.admission_windows, emit_times))
    assert rec.admission_windows() == sched.admission_windows


# ---------------------------------------------------------------------------
# A live serve run against the reference's
# ---------------------------------------------------------------------------

def _span_set(rec):
    return ({(s.name, s.cat) for s in rec.spans}, {(s.name, s.cat) for s in rec.instants})


@pytest.mark.parametrize("kw", [dict(prefill_groups_per_chunk=1, max_concurrent_admissions=4),
                                dict(prefill_groups_per_chunk=0)],
                         ids=["interleaved", "blocking"])
def test_serve_run_spans_and_counters_equal_reference(setup, kw):
    """A long first prompt drained in the idle loop, then four more on 2
    slots, each crossing a segment flush while it decodes: both packages'
    traces are valid and carry the same span names and categories (decode
    chunks, admission windows and rounds, transplants, flushes, idle-drain
    rounds, emits); the counters and the per-request lanes agree."""
    seg = setup[1].armt.segment_len
    jeng, teng = _engines(setup)
    reqs = _reqs([6 * seg, seg + seg // 2, seg, seg + seg // 2, seg], seg + 2)
    want = [(e.req_id, int(e.token)) for e in JScheduler(jeng, n_slots=2, chunk=4, **kw).run(
        [JRequest(*r) for r in reqs])]
    got = [(e.req_id, int(e.token)) for e in ContinuousScheduler(
        teng, n_slots=2, chunk=4, **kw).run([Request(*r) for r in reqs])]
    assert got == want and len(got) == 5 * (seg + 2)
    trace = teng.telemetry.trace.chrome_trace()
    assert validate_chrome_trace(trace) == [] and j_validate(trace) == []
    assert _span_set(teng.telemetry.trace) == _span_set(jeng.telemetry.trace)
    cats = {e.get("cat") for e in trace["traceEvents"] if e.get("ph") in ("X", "i")}
    expected = {"decode", "admission", "transplant", "flush", "emit"}
    if kw["prefill_groups_per_chunk"]:
        expected.add("idle")
    assert expected <= cats
    snap, jsnap = teng.telemetry.snapshot(), jeng.telemetry.snapshot()
    for k in ("admissions_total", "decode_flushes_total"):
        assert snap["counters"][k] == jsnap["counters"][k] == 5, k
    for k in ("queue_wait_s", "chunk_active_slots", "chunk_queue_depth"):
        assert snap["histograms"][k]["count"] == jsnap["histograms"][k]["count"], k
    assert snap["gauges"]["pool_occupancy"] == jsnap["gauges"]["pool_occupancy"]
    lanes = {e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {f"req:r{i}" for i in range(5)} <= lanes


def test_store_spans_equal_reference(setup):
    """With a prefix cache and a session store, generate and serve emit the
    reference's prefix_probe, session_restore, session_persist, prefill,
    decode and flush_segment spans and prefix_probe_total counters."""
    from repro.serve import PrefixCache as JPrefixCache, SessionStore as JSessionStore
    from repro_torch.serve import SessionStore
    jc, tc, jp, tp = setup
    seg = tc.armt.segment_len
    jeng = _jengine(jp, jc, telemetry=JTelemetry(trace=True, registry=JRegistry()),
                    prefix_cache=JPrefixCache(seg), session_store=JSessionStore())
    teng = ServeEngine(tp, tc, device="cpu", max_len=MAX_LEN,
                       telemetry=Telemetry(trace=True, registry=MetricsRegistry()),
                       prefix_cache=PrefixCache(seg), session_store=SessionStore())
    p, q = _toks(2 * seg + 3, 1), _toks(seg, 2)        # q resumes across a boundary
    for eng, R in ((jeng, JRequest), (teng, Request)):
        eng.generate(p[None], 3)
        eng.generate(p[None], 3, session_id="s")
        eng.generate(q[None], 3, session_id="s")
        list(eng.serve([R("a", p, 4, "t"), R("b", q, 4)], n_slots=2, chunk=2))
        list(eng.serve([R("c", q, 4, "t")], n_slots=2, chunk=2))
    assert _span_set(teng.telemetry.trace) == _span_set(jeng.telemetry.trace)
    names = {s.name for s in teng.telemetry.trace.spans}
    assert {"prefix_probe", "session_restore", "session_persist", "prefill", "decode",
            "flush_segment", "transplant", "admission_round"} <= names
    tc_, jc_ = teng.telemetry.snapshot()["counters"], jeng.telemetry.snapshot()["counters"]
    for k in ("prefix_probe_total{result=hit}", "prefix_probe_total{result=miss}"):
        assert tc_[k] == jc_[k], k
    assert validate_chrome_trace(teng.telemetry.trace.chrome_trace()) == []


def test_one_host_transfer_per_chunk_with_telemetry(setup, monkeypatch):
    """Telemetry is host-side only: with the trace and metrics on, the
    scheduler still makes its one device-to-host transfer per decode chunk
    (the tokens and the finite flags together; the reference makes two, its
    token and mask blocks), and no span, instant or metric holds a
    tensor."""
    seg = setup[1].armt.segment_len
    calls = []
    real = sched_mod._host

    def counting(t):
        calls.append(1)
        return real(t)
    monkeypatch.setattr(sched_mod, "_host", counting)
    _, teng = _engines(setup)
    tel = teng.telemetry
    sched = ContinuousScheduler(teng, n_slots=2, chunk=4)
    n_tok = sum(1 for _ in sched.run([Request(*r) for r in _reqs([seg, seg + seg // 2, seg],
                                                                  seg + 2)]))
    assert n_tok == 3 * (seg + 2)
    n_chunks = sum(1 for s in tel.trace.spans if s.name == "decode_chunk")
    assert n_chunks > 0 and len(calls) == n_chunks
    values = [v for s in tel.trace.spans + tel.trace.instants for v in s.args.values()]
    snap = tel.snapshot()
    values += list(snap["counters"].values()) + list(snap["gauges"].values())
    assert not any(isinstance(v, torch.Tensor) for v in values)


def test_telemetry_off_leaves_events_unchanged(setup):
    """The same requests with telemetry fully on and disabled: the same
    events; a disabled engine's generate has no metrics and the same
    tokens."""
    jc, tc, jp, tp = setup
    seg = tc.armt.segment_len
    reqs = _reqs([2 * seg + 1, seg - 1, 9], 7, seed=5)

    def run(tel):
        eng = ServeEngine(tp, tc, device="cpu", max_len=MAX_LEN, telemetry=tel)
        return ([(e.req_id, int(e.token), e.index, e.done)
                 for e in eng.serve([Request(*r) for r in reqs], n_slots=2, chunk=3)],
                eng.generate(reqs[0][1][None], 4))
    (ev_on, r_on), (ev_off, r_off) = (run(Telemetry(trace=True, registry=MetricsRegistry())),
                                      run(Telemetry.disabled()))
    assert ev_on == ev_off
    assert r_off.metrics is None and r_on.metrics is not None
    assert np.array_equal(r_on.tokens, r_off.tokens)


def test_generation_result_metrics(setup):
    """GenerationResult.metrics: the registry's snapshot with the probes
    (program counts, the prefix cache's stats) and the probe counter and
    TTFT histogram, as the reference's."""
    jc, tc, jp, tp = setup
    seg = tc.armt.segment_len
    eng = ServeEngine(tp, tc, device="cpu", max_len=MAX_LEN,
                      telemetry=Telemetry(registry=MetricsRegistry()),
                      prefix_cache=PrefixCache(seg, max_bytes=1 << 20))
    res = eng.generate(_toks(seg, 0)[None], 4)
    probes = res.metrics["probes"]
    assert probes["engine_program_counts"] == {"decode_steps": 1, "flushes": 1, "captured": 0,
                                               "total": 2}
    assert probes["prefix_cache"]["misses"] == 1 and probes["prefix_cache"]["insertions"] == 1
    assert res.metrics["counters"]["prefix_probe_total{result=miss}"] == 1
    assert res.metrics["histograms"]["generate_ttft_s"]["count"] == 1
    snap = eng.metrics_snapshot()
    assert snap["prefix_cache"] == eng.prefix_cache.stats.as_dict()
    assert snap["program_counts"]["total"] == 2


def test_program_counts_do_not_grow_with_prompt_lengths(setup):
    """The counterpart of the reference's compile budget: the port builds no
    program per prompt shape. Serve over six prompt lengths, then four new
    ones: the engine's decode programs (the 4-slot step and flush) stay
    the same two."""
    jc, tc, jp, tp = setup
    seg = tc.armt.segment_len
    eng = ServeEngine(tp, tc, device="cpu", max_len=512,
                      telemetry=Telemetry(registry=MetricsRegistry()))

    def run(lens, seed):
        for _ in ContinuousScheduler(eng, n_slots=2, chunk=4).run(
                [Request(*r) for r in _reqs(lens, 4, seed=seed)]):
            pass
    run([seg, seg + 7, 2 * seg, 2 * seg + seg // 2, 3 * seg, 4 * seg], seed=0)
    budget = eng.program_counts()
    run([seg + 12, 2 * seg + 9, 3 * seg + 5, 2 * seg + 11], seed=9)
    assert eng.program_counts() == budget == {"decode_steps": 1, "flushes": 1,
                                              "captured": 0, "total": 2}
    assert eng.metrics_snapshot()["probes"]["engine_program_counts"] == budget


def test_disabled_telemetry_is_noop():
    tel = Telemetry.disabled()
    assert not tel.on and tel.snapshot() is None
    tel.inc("x")
    tel.observe("y", 1.0)
    tel.set_gauge("z", 2.0)
    tel.add_span("a", "decode", 0.0, 1.0)
    tel.instant("b", "flush")
    tel.emit("r", 0.0, 1)
    with tel.span("c", "decode"):
        pass
    tel.sample_device_memory("cpu")
    on = Telemetry(registry=MetricsRegistry())
    on.sample_device_memory("cpu")                      # no CUDA device: no gauge
    assert on.snapshot()["gauges"] == {}
