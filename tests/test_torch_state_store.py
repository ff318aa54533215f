"""The port's serving state stores (``serve/state_store.py``) and the named
blobs they spill to (``checkpoint/manager.py``), against the JAX reference
at smoke size (llama-1b-armt, fp32, CPU; the reference's own tests use
h2o-danube, which the port lacks): the prefix hash keys byte for byte, the
boundary captures of both schedules, prefix-cache hits and session resumes
through ``generate`` and ``serve`` (blocking, interleaved and pooled), the
stores' stats after the same traffic, eviction, spill and restore. The
reference engines are built with ``bucket_prompts=False``: the port
prefills a prompt's whole segments in one stage, as the reference does
without bucketing.

The port's own cases: a bf16 blob round trip to the bit, the aliasing of
state updated in place (two hits on one prefix leave the snapshot as it
was; a stored session survives another ``generate`` on the same engine),
cache-mode sessions, the byte estimate's capture term, and the pure-SSM
engine's prefix cache, which needs the model's segment."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import PrefixCache as JPrefixCache  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import SessionStore as JSessionStore  # noqa: E402
from repro.serve import prefix_hash_chain as j_chain  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro.serve.scheduler import RequestError as JRequestError  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.memory import recurrent_state as t_recurrent_state  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import (PrefixCache, Request, RequestError, ServeEngine,  # noqa: E402
                               SessionEvicted, SessionStore, prefix_hash_chain)

ARCH = "llama-1b-armt"
# fp32 both sides (as tests/test_torch_serve.py)
ATOL, RTOL = 1e-4, 1e-3
MAX_LEN = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU ops: the suite runs in
    parallel workers, and the default pool of every worker oversubscribes
    the machine's cores. The count before is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(arch):
    """(jax cfg, port cfg, jax params, port params) of a smoke config, the
    reference's weights drawn once per module (jitted)."""
    if arch not in _MODELS:
        jc, tc = j_smoke(arch), t_smoke(arch)
        jp = jax.jit(lambda key: jmodel.init_params(jc, key))(jax.random.PRNGKey(0))
        _MODELS[arch] = (jc, tc, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                                     "cpu"))
    return _MODELS[arch]


@pytest.fixture(scope="module")
def setup():
    return _model(ARCH)


@pytest.fixture(scope="module")
def base(setup):
    """The port's engine without stores: the tokens every hit and resume
    must give."""
    return ServeEngine(setup[3], setup[1], device="cpu", max_len=MAX_LEN)


# The reference engine's jitted programs (decode step, flush, decode
# loops, scheduler and pipeline steps) close over the config, serve mode and
# segment length only, never over its stores (host-side), so every engine
# of one setting shares the first one's: each program compiles once per
# module, not once per engine.
_JIT_ATTRS = ("_step", "_flush", "_loops", "_sched_fns", "_pipe_steps", "_fused_fns",
              "_pool_steps")
_FIRST = {}


def _jengine(jp, jc, **kw):
    """A reference engine (``bucket_prompts=False``) sharing its jitted
    programs with the first engine of the same config, serve mode and
    max_len."""
    eng = JEngine(jp, jc, bucket_prompts=False, **kw)
    first = _FIRST.setdefault((jc.name, eng.serve_mode, eng.max_len), eng)
    for attr in _JIT_ATTRS:
        setattr(eng, attr, getattr(first, attr))
    return eng


def _engines(setup, **stores):
    """(reference engine, port engine), each with its own stores of the
    same settings: stores maps 'prefix_cache' / 'session_store' to a dict
    of the store's arguments (a spill dir gets a per-package subdir)."""
    jc, tc, jp, tp = setup
    seg = jc.armt.segment_len
    jkw, tkw = {}, {}
    for name, kw in stores.items():
        kj, kt = dict(kw), dict(kw)
        if "spill_dir" in kw:
            kj["spill_dir"], kt["spill_dir"] = kw["spill_dir"] / "ref", kw["spill_dir"] / "port"
        if name == "prefix_cache":
            jkw[name], tkw[name] = JPrefixCache(seg, **kj), PrefixCache(seg, **kt)
        else:
            jkw[name], tkw[name] = JSessionStore(**kj), SessionStore(**kt)
    return (_jengine(jp, jc, serve_mode="armt", max_len=MAX_LEN, **jkw),
            ServeEngine(tp, tc, device="cpu", max_len=MAX_LEN, **tkw))


def _toks(n, seed):
    return np.random.default_rng(seed).integers(8, 256, (n,)).astype(np.int32)


def _gen(eng, prompt, n, **kw):
    """Greedy tokens [n] of one generate on either package's engine."""
    if isinstance(eng, JEngine):
        return np.asarray(eng.generate(jnp.asarray(prompt[None]), n, **kw).tokens)[0]
    return eng.generate(prompt[None], n, **kw).tokens[0]


def _stats(store):
    return store.stats.as_dict()


def _stream(events):
    out = []
    for e in events:
        if isinstance(e, (RequestError, JRequestError)):
            out.append(("error", e.req_id, e.code))
        else:
            out.append((e.req_id, int(e.token), e.index, e.done))
    return out


def _serve_both(jeng, teng, reqs, **kw):
    """The same requests, (id, prompt, max_new, session) each, through both
    front doors -> (reference events, port events)."""
    want = _stream(jeng.serve([JRequest(*r) for r in reqs], **kw))
    got = _stream(teng.serve([Request(*r) for r in reqs], **kw))
    return want, got


def _tokens(stream):
    out = {}
    for e in stream:
        out.setdefault(e[0], []).append(e[1])
    return out


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


# ---------------------------------------------------------------------------
# Hash keys and the capture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seg_len,n", [(16, 64), (16, 70), (7, 30), (1, 5)])
def test_prefix_hash_chain_equals_reference(seg_len, n):
    """The rolling keys byte for byte, prefix-stable, all distinct."""
    a = _toks(n, seed=n)
    got = prefix_hash_chain(a, seg_len)
    assert got == j_chain(a, seg_len) and len(got) == n // seg_len
    b = np.concatenate([a, _toks(2 * seg_len, seed=1)])
    assert prefix_hash_chain(b, seg_len)[:len(got)] == got
    assert len(set(got)) == len(got)


@pytest.mark.parametrize("schedule", ["diagonal", "sequential"])
def test_boundary_capture_matches_prefix_forward_and_reference(setup, schedule):
    """Boundary c of forward_hidden's capture equals the final state of a
    forward over the first c segments (to the bit for the sequential
    schedule; the diagonal one's bands differ in width on the CPU) and the
    reference's capture (within fp32 summation order: each boundary's
    relative L2 error, as the ARMT state grows by orders of magnitude per
    segment); boundary S is the run's own final state."""
    jc, tc, jp, tp = setup
    seg, S = tc.armt.segment_len, 3
    toks = _toks(S * seg, seed=11)[None]
    h, fin, cap = tmodel.forward_hidden(tp, tc, torch.from_numpy(toks).long(),
                                        schedule=schedule, capture_states=True)
    _, _, jcap = jmodel.forward_hidden(jp, jc, jnp.asarray(toks), schedule=schedule,
                                       capture_states=True)
    assert h.shape[0] == S
    tree = cap["pattern"][0]
    jtree = jcap["pattern"][0]
    for k in ("A", "z"):
        assert tree[k].shape[0] == S
        for c in range(S):
            want = torch.from_numpy(np.array(jtree[k][c])).double()
            assert (tree[k][c].double() - want).norm() <= 1e-5 * want.norm(), (k, c)
        assert torch.equal(tree[k][S - 1], fin["pattern"][0][k])
    for c in (1, 2):
        _, fin_c = tmodel.forward_hidden(tp, tc, torch.from_numpy(toks[:, :c * seg]).long(),
                                         schedule=schedule)
        for k in ("A", "z"):
            if schedule == "sequential":
                assert torch.equal(tree[k][c - 1], fin_c["pattern"][0][k])
            else:
                torch.testing.assert_close(tree[k][c - 1], fin_c["pattern"][0][k],
                                           atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Prefix cache
# ---------------------------------------------------------------------------

def test_prefix_cache_hit_matches_reference(setup, base):
    """A cold run fills both caches; prompts sharing its 3 segments with
    tails of 0 (the exact full hit), 1, seg - 1 and seg + 3 tokens hit 3
    segments and give the reference's tokens and the port's uncached
    engine's; both caches' stats are equal after the traffic."""
    seg = setup[1].armt.segment_len
    jeng, teng = _engines(setup, prefix_cache={})
    shared = _toks(3 * seg, seed=1)
    cold = teng.generate(shared[None], 4)
    assert cold.cached_segments == 0
    assert list(cold.tokens[0]) == list(_gen(jeng, shared, 4)) == list(_gen(base, shared, 4))
    for i, tail in enumerate((0, 1, seg - 1, seg + 3)):
        prompt = np.concatenate([shared, _toks(tail, seed=20 + i)])
        hit = teng.generate(prompt[None], 4)
        assert hit.cached_segments == 3, tail
        want = _gen(jeng, prompt, 4)
        assert list(hit.tokens[0]) == list(want) == list(_gen(base, prompt, 4)), tail
    assert _stats(teng.prefix_cache) == _stats(jeng.prefix_cache)
    assert teng.prefix_cache.stats.hits == 4


def test_exact_full_hit_logits_are_the_boundary_logits(setup):
    """An exact full hit runs no forward: its first logits are the stored
    boundary logits, within fp32 tolerance of the cold prefill's last
    logits (another matmul shape over the same row)."""
    seg = setup[1].armt.segment_len
    _, teng = _engines(setup, prefix_cache={})
    prompt = torch.from_numpy(_toks(2 * seg, seed=3)).long()[None]
    cold, _, _, n0 = teng.prefill(prompt)
    hit, dstate, pos, n1 = teng.prefill(prompt)
    assert (n0, n1, pos) == (0, 2, 0)
    torch.testing.assert_close(hit, cold, atol=ATOL, rtol=RTOL)


def test_prefix_cache_longest_match_wins(setup):
    """A prompt sharing a shorter prefix hits the shorter boundary; its own
    boundaries, inserted by that run, then give the full match."""
    seg = setup[1].armt.segment_len
    jeng, teng = _engines(setup, prefix_cache={})
    a = _toks(4 * seg, seed=2)
    b = np.concatenate([a[:2 * seg], _toks(2 * seg, seed=3)])
    for eng in (jeng, teng):
        _gen(eng, a, 2)
    r = teng.generate(b[None], 4)
    assert r.cached_segments == 2 and list(r.tokens[0]) == list(_gen(jeng, b, 4))
    r2 = teng.generate(b[None], 4)
    assert r2.cached_segments == 4 and (r2.tokens == r.tokens).all()
    _gen(jeng, b, 4)
    assert _stats(teng.prefix_cache) == _stats(jeng.prefix_cache)


def test_hash_collision_full_verification(setup):
    """A forged collision (a's entry under other's key) is verified on the
    full tokens and falls through, counted."""
    seg = setup[1].armt.segment_len
    _, teng = _engines(setup, prefix_cache={})
    cache = teng.prefix_cache
    a, other = _toks(2 * seg, seed=4), _toks(2 * seg, seed=5)
    teng.generate(a[None], 2)
    lru = cache._lru
    lru.entries[prefix_hash_chain(other, seg)[-1]] = lru.entries.pop(
        prefix_hash_chain(a, seg)[-1])
    n, snap = cache.match(other)
    assert n == 0 and snap is None and cache.stats.collisions == 1


def test_lru_eviction_byte_budget_matches_reference(setup):
    """Snapshots cost the reference's bytes; under a budget of 3.5 of them
    the oldest goes first, a hit refreshes recency, and both caches' stats
    agree after the same traffic."""
    seg = setup[1].armt.segment_len
    jeng, teng = _engines(setup, prefix_cache={})
    for eng in (jeng, teng):
        _gen(eng, _toks(seg, seed=6), 2)
    one = teng.prefix_cache.stats.bytes_in_ram
    assert one == jeng.prefix_cache.stats.bytes_in_ram > 0
    jeng, teng = _engines(setup, prefix_cache=dict(max_bytes=3 * one + one // 2))
    prompts = [_toks(seg, seed=10 + i) for i in range(3)]
    for eng in (jeng, teng):
        cache = eng.prefix_cache
        for p in prompts:
            _gen(eng, p, 2)
        assert len(cache) == 3 and cache.stats.evictions == 0
        assert cache.match(prompts[0])[0] == 1          # touched: now the most recent
        _gen(eng, _toks(seg, seed=13), 2)
        assert cache.stats.evictions == 1
        assert cache.match(prompts[0])[0] == 1 and cache.match(prompts[1])[0] == 0
    assert _stats(teng.prefix_cache) == _stats(jeng.prefix_cache)


def test_spill_to_disk_and_restore_matches_reference(setup, base, tmp_path):
    """An evicted snapshot spills to a named blob and is restored on the
    next hit, which gives the uncached tokens; the stats equal the
    reference's."""
    seg = setup[1].armt.segment_len
    _, probe = _engines(setup, prefix_cache={})
    p0, p1 = _toks(seg, seed=30), _toks(seg, seed=31)
    probe.generate(p0[None], 2)
    one = probe.prefix_cache.stats.bytes_in_ram
    jeng, teng = _engines(setup, prefix_cache=dict(max_bytes=one + one // 2,
                                                   spill_dir=tmp_path))
    prompt = np.concatenate([p0, _toks(3, seed=32)])
    for eng in (jeng, teng):
        _gen(eng, p0, 2)
        _gen(eng, p1, 2)                              # spills p0's snapshot
        assert eng.prefix_cache.stats.spills == 1
    hit = teng.generate(prompt[None], 4)
    assert hit.cached_segments == 1 and teng.prefix_cache.stats.restores == 1
    assert list(hit.tokens[0]) == list(_gen(jeng, prompt, 4)) == list(_gen(base, prompt, 4))
    assert _stats(teng.prefix_cache) == _stats(jeng.prefix_cache)


def test_two_hits_on_one_prefix_leave_the_snapshot_unchanged(setup, base):
    """Aliasing: the executor and the decode programs update state in
    place, so a hit must hand them copies. Two hits on one prefix (an
    exact full hit and one with a tail) leave the stored snapshot's bits as
    they were, and give the same tokens as the uncached engine both times;
    the snapshot shares no storage with the capture it came from."""
    seg = setup[1].armt.segment_len
    _, teng = _engines(setup, prefix_cache={})
    shared = _toks(2 * seg, seed=33)
    teng.generate(shared[None], 3)
    n, snap = teng.prefix_cache.match(shared)
    assert n == 2
    before = [t.clone() for t in _leaves((snap.state, snap.logits))]
    storages = {t.untyped_storage().data_ptr() for t in _leaves(snap.state)}
    assert len(storages) == len(_leaves(snap.state))          # each leaf its own
    assert all(t.untyped_storage().nbytes() == t.numel() * t.element_size()
               for t in _leaves(snap.state))                  # no retained capture
    for tail in (0, 5, 0, 5):
        prompt = np.concatenate([shared, _toks(tail, seed=34)])
        r = teng.generate(prompt[None], 6)
        assert r.cached_segments == 2
        assert list(r.tokens[0]) == list(_gen(base, prompt, 6))
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves((snap.state, snap.logits))))


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------

def test_session_resume_matches_reference_and_history(setup, base):
    """A 3-turn session (the first turn ends mid-segment, the second stays
    inside it, the third crosses two boundaries): each turn's tokens equal
    the reference's session and one generate over the whole history."""
    seg = setup[1].armt.segment_len
    jeng, teng = _engines(setup, session_store={})
    turns = [_toks(seg + 5, seed=40), _toks(7, seed=41), _toks(2 * seg, seed=42)]
    history = np.empty(0, np.int32)
    for i, t in enumerate(turns):
        r = teng.generate(t[None], 6, session_id="conv")
        assert r.resumed == (i > 0) and r.session_id == "conv"
        assert list(r.tokens[0]) == list(_gen(jeng, t, 6, session_id="conv")), i
        assert list(r.tokens[0]) == list(_gen(base, np.concatenate([history, t]), 6)), i
        history = np.concatenate([history, t, r.tokens[0]]).astype(np.int32)
    entry = teng.session_store.get("conv")
    assert np.array_equal(entry.tokens, history)
    assert np.array_equal(entry.tokens, jeng.session_store.get("conv").tokens)
    assert _stats(teng.session_store) == _stats(jeng.session_store)


def test_stored_session_survives_another_generate(setup, base):
    """Aliasing: generate's decode program is updated in place, so the
    state a session stores must be a copy. A stored session, then another
    generate on the same engine (other prompt, same batch), then the
    resume: the resume equals one generate over the history."""
    seg = setup[1].armt.segment_len
    _, teng = _engines(setup, session_store={})
    t1, t2 = _toks(seg + 3, seed=43), _toks(6, seed=44)
    r1 = teng.generate(t1[None], 5, session_id="s")
    stored = [t.clone() for t in _leaves(teng.session_store.get("s").state)]
    teng.generate(_toks(2 * seg + 1, seed=45)[None], 9)          # overwrites the program
    assert all(torch.equal(a, b) for a, b in zip(stored, _leaves(
        teng.session_store.get("s").state)))
    r2 = teng.generate(t2[None], 5, session_id="s")
    hist = np.concatenate([t1, r1.tokens[0], t2])
    assert list(r2.tokens[0]) == list(_gen(base, hist, 5))


@pytest.mark.parametrize("k", [0, 2])
def test_scheduler_session_resume_matches_reference(setup, base, k):
    """Sessions through serve, blocking (k = 0) and interleaved (k = 2):
    turn 1 co-batched with another request, turn 2 alone, then turn 3
    through generate: the reference's events, and each turn's tokens those
    of one generate over the history (the slot's row is lifted out at the
    chunk it finished, every emitted token consumed)."""
    seg = setup[1].armt.segment_len
    jeng, teng = _engines(setup, session_store={})
    p1, p2, p3 = _toks(2 * seg + 3, seed=50), _toks(9, seed=51), _toks(4, seed=53)
    kw = dict(n_slots=2, chunk=3, prefill_groups_per_chunk=k)
    want, got = _serve_both(jeng, teng, [("t1", p1, 7, "c"), ("x", _toks(5, seed=52), 4, None)],
                            **kw)
    assert got == want
    o1 = _tokens(got)["t1"]
    want, got = _serve_both(jeng, teng, [("t2", p2, 7, "c")], **kw)
    assert got == want
    hist = np.concatenate([p1, o1, p2])
    assert _tokens(got)["t2"] == list(_gen(base, hist, 7))
    g = teng.generate(p3[None], 4, session_id="c")
    hist = np.concatenate([hist, _tokens(got)["t2"], p3])
    assert list(g.tokens[0]) == list(_gen(jeng, p3, 4, session_id="c"))
    assert list(g.tokens[0]) == list(_gen(base, hist, 4))
    assert _stats(teng.session_store) == _stats(jeng.session_store)


def test_session_eviction_is_loud(setup):
    """An evicted session (no spill) raises in generate and is a
    session_evicted event in serve, as in the reference; an unknown id
    starts fresh."""
    seg = setup[1].armt.segment_len
    jeng, teng = _engines(setup, session_store=dict(max_bytes=1))
    for eng in (jeng, teng):
        _gen(eng, _toks(seg, seed=60), 3, session_id="gone")
        assert eng.session_store.stats.evictions == 1
    with pytest.raises(SessionEvicted):
        teng.generate(_toks(4, seed=61)[None], 3, session_id="gone")
    for kw in (dict(prefill_groups_per_chunk=0), {}):
        want, got = _serve_both(jeng, teng, [("r", _toks(4, seed=62), 3, "gone")],
                                n_slots=1, **kw)
        assert got == want == [("error", "r", "session_evicted")]
    want, got = _serve_both(jeng, teng, [("r2", _toks(4, seed=63), 3, "fresh")], n_slots=1)
    assert got == want and len(got) == 3
    with pytest.raises(ValueError, match="session_store"):
        ServeEngine(setup[3], setup[1], device="cpu").generate(_toks(4, 0)[None], 2,
                                                                 session_id="x")


def test_session_spill_roundtrip_matches_reference(setup, base, tmp_path):
    """A session spilled on every put (a budget of 1 byte) is restored for
    the next turn, to the device it was stored from: the tokens of one
    generate over the history, and the reference's stats."""
    seg = setup[1].armt.segment_len
    jeng, teng = _engines(setup, session_store=dict(max_bytes=1, spill_dir=tmp_path))
    p1, p2 = _toks(seg + 2, seed=64), _toks(5, seed=65)
    r1 = teng.generate(p1[None], 4, session_id="s")
    assert teng.session_store.stats.spills == 1
    r2 = teng.generate(p2[None], 4, session_id="s")
    assert r2.resumed and teng.session_store.stats.restores == 1
    assert list(r2.tokens[0]) == list(_gen(base, np.concatenate([p1, r1.tokens[0], p2]), 4))
    for p in (p1, p2):
        _gen(jeng, p, 4, session_id="s")
    assert _stats(teng.session_store) == _stats(jeng.session_store)


def test_cache_mode_sessions_match_reference(setup):
    """Full-KV serving keeps a session's whole cache: three turns through
    generate and one through serve give the reference's tokens, and the
    length check counts the session's tokens."""
    jc, tc, jp, tp = setup
    jeng = _jengine(jp, jc, serve_mode="cache", max_len=96, session_store=JSessionStore())
    teng = ServeEngine(tp, tc, serve_mode="cache", max_len=96, device="cpu",
                       session_store=SessionStore())
    for i, n in enumerate((21, 6, 13)):
        t = _toks(n, seed=70 + i)
        assert list(teng.generate(t[None], 5, session_id="c").tokens[0]) == list(
            _gen(jeng, t, 5, session_id="c")), i
    want, got = _serve_both(jeng, teng, [("r", _toks(8, seed=74), 6, "c")],
                            n_slots=2, chunk=4)
    assert got == want and len(got) == 6
    with pytest.raises(ValueError, match="session tokens"):
        teng.generate(_toks(30, seed=75)[None], 10, session_id="c")


@pytest.mark.parametrize("k", [0, 4], ids=["blocking", "k4"])
def test_cache_mode_session_past_max_len_is_rejected_in_serve(setup, k):
    """A resumed cache-mode turn that fits max_len alone but not after the
    session's stored tokens: serve rejects it as invalid_request, as
    generate raises, and the stored session is left as it was (the next
    turn that fits still resumes it, equal to the reference's)."""
    jc, tc, jp, tp = setup
    jeng = _jengine(jp, jc, serve_mode="cache", max_len=64, session_store=JSessionStore())
    teng = ServeEngine(tp, tc, serve_mode="cache", max_len=64, device="cpu",
                       session_store=SessionStore())
    t1 = _toks(30, seed=76)
    assert list(teng.generate(t1[None], 5, session_id="c").tokens[0]) == list(
        _gen(jeng, t1, 5, session_id="c"))
    long_turn = _toks(20, seed=77)                   # 20 + 10 <= 64, but not after 35
    with pytest.raises(ValueError, match="session tokens"):
        teng.generate(long_turn[None], 10, session_id="c")
    pos = teng.session_store.get("c").pos
    got = _stream(teng.serve([Request("r", long_turn, 10, "c")], n_slots=2, chunk=4,
                             prefill_groups_per_chunk=k))
    assert got == [("error", "r", "invalid_request")]
    assert teng.session_store.get("c").pos == pos
    t2 = _toks(6, seed=78)
    want, got = _serve_both(jeng, teng, [("r2", t2, 5, "c")], n_slots=2, chunk=4,
                            prefill_groups_per_chunk=k)
    assert got == want and len(got) == 5


# ---------------------------------------------------------------------------
# Interleaved and pooled admission with the stores
# ---------------------------------------------------------------------------

def test_interleaved_prefix_cache_hits(setup):
    """Blocking and interleaved admission (one at a time) through a prefix
    cache: the reference's events, and equal cache stats (hits and
    insertions) between both modes and both packages: the pipeline's
    capture feeds the cache as the blocking prefill's does."""
    seg = setup[1].armt.segment_len
    sys_p = _toks(3 * seg, seed=20)
    reqs = [(f"p{i}", np.concatenate([sys_p, _toks(5, seed=21 + i)]), 6, None)
            for i in range(3)]
    stats, outs = {}, {}
    for mode, k in (("blocking", 0), ("interleaved", 2)):
        jeng, teng = _engines(setup, prefix_cache=dict(max_bytes=64 << 20))
        want, got = _serve_both(jeng, teng, reqs, n_slots=2, chunk=3,
                                prefill_groups_per_chunk=k, max_concurrent_admissions=1)
        assert got == want, mode
        assert _stats(teng.prefix_cache) == _stats(jeng.prefix_cache), mode
        outs[mode], stats[mode] = _tokens(got), _stats(teng.prefix_cache)
    assert outs["interleaved"] == outs["blocking"]
    assert stats["interleaved"]["hits"] == stats["blocking"]["hits"] >= 1
    assert stats["interleaved"]["insertions"] == stats["blocking"]["insertions"]


def test_interleaved_session_resume(setup):
    """Sessions across serve calls under interleaved admission: the
    reference's events, and the blocking scheduler's tokens."""
    seg = setup[1].armt.segment_len
    t1, t2 = _toks(2 * seg + 3, seed=30), _toks(9, seed=31)
    got = {}
    for mode, k in (("blocking", 0), ("interleaved", 2)):
        jeng, teng = _engines(setup, session_store=dict(max_bytes=64 << 20))
        kw = dict(n_slots=2, chunk=3, prefill_groups_per_chunk=k)
        w1, g1 = _serve_both(jeng, teng, [("a", t1, 6, "c"), ("x", _toks(5, seed=32), 4, None)],
                             **kw)
        w2, g2 = _serve_both(jeng, teng, [("b", t2, 6, "c")], **kw)
        assert (g1, g2) == (w1, w2), mode
        got[mode] = (_tokens(g1), _tokens(g2))
    assert got["interleaved"] == got["blocking"]


def test_concurrent_prefix_cache_identity(setup):
    """Pooled concurrent admissions sharing a cached prefix: the
    reference's events and cache stats, and blocking's tokens (followers
    admitted together race the first member's insert, so hits differ from
    blocking's, as in the reference)."""
    seg = setup[1].armt.segment_len
    sys_p = _toks(2 * seg, seed=300)
    reqs = [(f"p{i}", np.concatenate([sys_p, _toks(seg + 3, seed=301 + i)]), 5, None)
            for i in range(4)]
    stats, outs = {}, {}
    for mode, kw in (("blocking", dict(prefill_groups_per_chunk=0)),
                     ("pooled", dict(prefill_groups_per_chunk=2,
                                     max_concurrent_admissions=3))):
        jeng, teng = _engines(setup, prefix_cache=dict(max_bytes=64 << 20))
        want, got = _serve_both(jeng, teng, reqs, n_slots=3, chunk=3, **kw)
        assert got == want, mode
        assert _stats(teng.prefix_cache) == _stats(jeng.prefix_cache), mode
        outs[mode], stats[mode] = _tokens(got), _stats(teng.prefix_cache)
    assert outs["pooled"] == outs["blocking"]
    assert stats["blocking"]["hits"] == 3 and stats["pooled"]["hits"] >= 1
    assert stats["pooled"]["collisions"] == stats["blocking"]["collisions"] == 0


# ---------------------------------------------------------------------------
# The port's own: blobs, the byte estimate, the pure-SSM engine
# ---------------------------------------------------------------------------

def test_named_blob_roundtrip_bitwise(tmp_path):
    """bf16 (stored as its raw bits), fp32 with NaN and inf, int64 and bool
    leaves come back to the bit and in their dtypes; a corrupted leaf is
    caught by its hash; a missing blob raises."""
    g = torch.Generator().manual_seed(0)
    leaves = {"conv": torch.randn(3, 5, generator=g).to(torch.bfloat16),
              "h": torch.tensor([1.0, float("nan"), float("inf"), -0.0]),
              "pos": torch.arange(4), "mask": torch.tensor([True, False])}
    mgr = CheckpointManager(tmp_path)
    mgr.save_named("session/a", leaves)
    assert mgr.has_named("session/a") and not mgr.has_named("session/b")
    back = mgr.restore_named("session/a")
    assert list(back) == list(leaves)
    for k, t in leaves.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape
        a, b = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x for x in (back[k], t))
        assert torch.equal(torch.nan_to_num(a.float()) if k == "h" else a,
                           torch.nan_to_num(b.float()) if k == "h" else b)
    assert torch.isnan(back["h"][1]) and torch.equal(back["h"][3].view(torch.int32),
                                                     leaves["h"][3].view(torch.int32))
    leaf = mgr._named_dir("session/a") / "leaf_0.npy"
    arr = np.load(leaf)
    arr.flat[0] ^= 1
    np.save(leaf, arr)
    with pytest.raises(IOError):
        mgr.restore_named("session/a")
    mgr.delete_named("session/a")
    with pytest.raises(FileNotFoundError):
        mgr.restore_named("session/a")


def test_session_store_delete_and_stats_match_reference():
    """The session store's bookkeeping on its own, against the reference's
    on the same calls: bytes counted from shapes and dtypes, delete of a
    live entry, a put over the budget evicting oldest first (with
    tombstones), and delete clearing a tombstone (the id starts fresh)."""
    got, want = SessionStore(max_bytes=100), JSessionStore(max_bytes=100)
    for store, lib in ((got, torch), (want, jnp)):
        small = {"prelude": (), "pattern": ({"A": lib.zeros((2, 5), dtype=lib.float32)},)}
        big = {"prelude": (), "pattern": ({"A": lib.zeros((8, 8), dtype=lib.float32)},)}
        store.put("a", state=small, pos=3, pending=[7], tokens=[1, 2])
        store.put("c", state=small, pos=1, pending=[], tokens=[4])
        assert store.stats.bytes_in_ram == 80
        store.delete("c")
        entry = store.get("a")
        assert entry.pos == 3 and list(entry.pending) == [7] and list(entry.tokens) == [1, 2]
        store.put("b", state=big, pos=0, pending=[], tokens=[3])     # evicts a, then b
        store.delete("b")
        assert store.get("b") is None and store.get("c") is None
        with pytest.raises(KeyError):                                # SessionEvicted
            store.get("a")
    assert got.stats.as_dict() == want.stats.as_dict()
    assert got.stats.bytes_in_ram == 0 and len(got) == 0


def test_byte_estimate_counts_the_capture(setup):
    """With a prefix cache, prefill_activation_bytes adds what a capturing
    admission holds at its end: the per-step capture beside the boundaries
    gathered from it, then the gather beside the snapshots and the
    boundary logits. The added term covers both on a 4-segment admission,
    from the tensors' own sizes."""
    jc, tc, jp, tp = setup
    seg, S = tc.armt.segment_len, 4
    plain = ServeEngine(tp, tc, device="cpu", max_len=MAX_LEN)
    cache = PrefixCache(seg, max_bytes=64 << 20)
    eng = ServeEngine(tp, tc, device="cpu", max_len=MAX_LEN, prefix_cache=cache)
    added = eng.prefill_activation_bytes(S) - plain.prefill_activation_bytes(S)
    pipe = eng.start_prefill(_toks(S * seg, seed=80)[None], groups_per_call=1)
    pipe.advance()
    cap_bytes = sum(t.numel() * t.element_size() for t in _leaves(pipe._carry["cap"]))
    while not pipe.advance():
        pass
    assert len(cache) == S
    state = sum(t.numel() * t.element_size() for t in _leaves(tmodel.init_state(tc, 1, "cpu")))
    logits = S * tc.vocab * 4
    assert cap_bytes + S * state <= added
    assert S * state + cache.stats.bytes_in_ram + logits <= added
    L = tc.n_layers
    assert added == (2 * S + L - 1) * state + S * tc.vocab * (8 + 4)     # fp32 weights


def test_falcon_prefix_cache_needs_the_models_segment(tmp_path):
    """A pure-SSM engine's seg_len is max_len, while the model prefills in
    segments of segment_len(cfg) (1024) and captures one state per model
    segment. The reference indexes that capture by engine boundary, so at
    max_len 64 its snapshot of the first boundary is not the state after
    64 tokens (it is the state after the whole 128-token prefill): the port
    refuses such a cache. At max_len 1024 both packages' hits give the cold
    run's tokens."""
    jc, tc, jp, tp = _model("falcon-mamba-7b")
    with pytest.raises(ValueError, match="segment"):
        ServeEngine(tp, tc, device="cpu", max_len=64, prefix_cache=PrefixCache(64))
    # the reference's caveat, on its own state
    jeng = _jengine(jp, jc, max_len=64, prefix_cache=JPrefixCache(64))
    prompt = _toks(128 + 5, seed=90)
    jeng.generate(jnp.asarray(prompt[None]), 2)
    n, snap = jeng.prefix_cache.match(prompt[:64])
    # the state after 64 tokens, from the port's plain sequential forward on
    # the same weights (tests/test_torch_mamba_model.py holds it to the
    # reference's within 1e-4)
    with torch.no_grad():
        _, fin64 = tmodel.forward_hidden(tp, tc, torch.from_numpy(prompt[None, :64]).long(),
                                         schedule="sequential", fused=False)
    assert n == 1
    assert not all(np.allclose(a.numpy(), np.asarray(b), atol=1e-4)
                   for a, b in zip(_leaves(t_recurrent_state(fin64)), _leaves(snap.state)))
    # at the model's segment the hits are the cold run's, in both packages
    seg = 1024
    jeng = _jengine(jp, jc, max_len=seg, prefix_cache=JPrefixCache(seg))
    teng = ServeEngine(tp, tc, device="cpu", max_len=seg, prefix_cache=PrefixCache(seg))
    cold = ServeEngine(tp, tc, device="cpu", max_len=seg)
    shared = _toks(2 * seg, seed=91)
    for eng in (jeng, teng):
        _gen(eng, shared, 3)
    for tail in (0, 7):
        prompt = np.concatenate([shared[:seg + seg * (tail == 0)], _toks(tail, seed=92)])
        r = teng.generate(prompt[None], 3)
        assert r.cached_segments == (2 if tail == 0 else 1)
        want = list(_gen(cold, prompt, 3))
        assert list(r.tokens[0]) == want == list(_gen(jeng, prompt, 3)), tail
    assert _stats(teng.prefix_cache) == _stats(jeng.prefix_cache)


def test_falcon_sessions_match_reference_and_resume_past_max_len():
    """falcon-mamba sessions (h and the conv tail): two turns give the
    reference's tokens; a third turn resumed from a position past max_len
    (a pure-SSM engine never flushes, so its position only grows) is fed as
    one piece and gives the tokens of one generate over the history."""
    jc, tc, jp, tp = _model("falcon-mamba-7b")
    jeng = _jengine(jp, jc, max_len=64, session_store=JSessionStore())
    teng = ServeEngine(tp, tc, device="cpu", max_len=64, session_store=SessionStore())
    base = ServeEngine(tp, tc, device="cpu", max_len=64)
    history = np.empty(0, np.int32)
    for i, n in enumerate((64 + 10, 7, 60)):
        t = _toks(n, seed=95 + i)
        r = teng.generate(t[None], 6, session_id="f")
        if i < 2:                   # the reference's position stays below max_len
            assert list(r.tokens[0]) == list(_gen(jeng, t, 6, session_id="f")), i
        assert list(r.tokens[0]) == list(_gen(base, np.concatenate([history, t]), 6)), i
        history = np.concatenate([history, t, r.tokens[0]]).astype(np.int32)
    assert teng.session_store.get("f").pos > 64


def test_serving_metrics(setup):
    """GenerationResult and the first and final StreamEvents carry host-clock
    TTFT and tok/s, and a result its store fields."""
    seg = setup[1].armt.segment_len
    _, teng = _engines(setup, prefix_cache={}, session_store={})
    r = teng.generate(_toks(seg + 4, seed=90)[None], 5, session_id="m")
    assert r.ttft_s > 0 and r.tok_s > 0
    assert (r.cached_segments, r.session_id, r.resumed) == (0, "m", False)
    evs = list(teng.serve([Request("m", _toks(seg + 4, seed=91), 5)], n_slots=1, chunk=2))
    first, last = evs[0], evs[-1]
    assert first.ttft_s is not None and first.ttft_s > 0
    assert last.done and last.ttft_s == first.ttft_s and last.tok_s > 0


def test_prefix_cache_refused_where_the_reference_refuses(setup):
    """A cache-mode engine, and a cache of another segment length, are
    refused, as in the reference."""
    jc, tc, jp, tp = setup
    seg = tc.armt.segment_len
    with pytest.raises(ValueError, match="armt"):
        ServeEngine(tp, tc, device="cpu", serve_mode="cache", max_len=64,
                    prefix_cache=PrefixCache(seg))
    with pytest.raises(ValueError, match="seg_len"):
        ServeEngine(tp, tc, device="cpu", prefix_cache=PrefixCache(seg + 1))
    # B > 1 bypasses the cache: no probe, no insert
    eng = ServeEngine(tp, tc, device="cpu", max_len=MAX_LEN, prefix_cache=PrefixCache(seg))
    r = eng.generate(np.stack([_toks(2 * seg, 1), _toks(2 * seg, 2)]), 3)
    assert r.cached_segments == 0 and eng.prefix_cache.stats.as_dict() == dataclasses.asdict(
        type(eng.prefix_cache.stats)())
