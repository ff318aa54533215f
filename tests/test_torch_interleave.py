"""Interleaved admission in the port's ``ServeEngine.serve`` against the JAX
reference at smoke size (fp32, CPU): the event streams, in order, equal
those of the reference's ``ServeEngine(bucket_prompts=False)`` run with the
same arguments (its power-of-two stages would otherwise change the rounds
at which admissions land), and every request's tokens equal the port's
blocking admission; ``PrefillPipeline`` equals the blocking prefill to the
bit; the byte estimate's carry equals the reference's less its drain
padding; and a suspended carry never
shares storage with the decode pool or another admission."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import ContinuousScheduler, Request, ServeEngine, StreamEvent  # noqa: E402
from repro_torch.serve.engine import AdmissionPool  # noqa: E402

ARCH = "llama-1b-armt"


@pytest.fixture(scope="module")
def engines():
    jc, tc = j_smoke(ARCH), t_smoke(ARCH)
    jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jeng = JEngine(jp, jc, serve_mode="armt", schedule="diagonal", max_len=256,
                   bucket_prompts=False)
    return jeng, ServeEngine(tp, tc, device="cpu", max_len=256), jc.armt.segment_len, jc.vocab


def _requests(lens, max_new, vocab, seed):
    rng = np.random.default_rng(seed)
    return [(f"r{i}", rng.integers(8, vocab, n), m)
            for i, (n, m) in enumerate(zip(lens, max_new))]


def _stream(events):
    return [(e.req_id, int(e.token), e.index, e.done) for e in events]


def _tokens(stream):
    out = {}
    for rid, tok, _, _ in stream:
        out.setdefault(rid, []).append(tok)
    return out


def _both(engines, reqs, **kw):
    jeng, teng = engines[:2]
    want = _stream(jeng.serve([JRequest(i, p, m) for i, p, m in reqs], **kw))
    got = list(teng.serve([Request(i, p, m) for i, p, m in reqs], **kw))
    assert all(isinstance(e, StreamEvent) for e in got)
    return want, _stream(got)


def _blocking(engines, reqs, **kw):
    kw = dict(kw, prefill_groups_per_chunk=0)
    for k in ("fused_admission", "max_concurrent_admissions", "admission_fairness"):
        kw.pop(k, None)
    return _tokens(_stream(engines[1].serve([Request(i, p, m) for i, p, m in reqs], **kw)))


MODES = [
    dict(prefill_groups_per_chunk=1),
    dict(prefill_groups_per_chunk=3),
    dict(prefill_groups_per_chunk=64),          # a whole stage per advance
    dict(prefill_groups_per_chunk=-1),          # a whole stage per advance, by rule
    dict(prefill_groups_per_chunk=2, fused_admission=True),
    dict(prefill_groups_per_chunk=1, fused_admission=True, max_concurrent_admissions=1),
    dict(max_concurrent_admissions=2),
    dict(max_concurrent_admissions=3, prefill_groups_per_chunk=1),
    dict(max_concurrent_admissions=None, prefill_groups_per_chunk=2),
    dict(admission_fairness="oldest_first", prefill_groups_per_chunk=1),
    dict(admission_fairness="oldest_first", fused_admission=True),
]


@pytest.mark.parametrize("kw", MODES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_interleaved_serve_matches_reference(engines, kw):
    """5 requests on 3 slots, chunk 4, prompts at and around segment
    boundaries and mid-segment (admissions landing while other slots
    decode): the same events in the same order as the reference, and the
    port's blocking tokens."""
    _, _, seg, vocab = engines
    lens = [2 * seg, 2 * seg + 1, seg - 1, 13, 3 * seg + seg // 2]
    reqs = _requests(lens, [6, 9, 6, 11, 6], vocab, seed=0)
    want, got = _both(engines, reqs, n_slots=3, chunk=4, **kw)
    assert got == want
    assert _tokens(got) == _blocking(engines, reqs, n_slots=3, chunk=4)


@pytest.mark.parametrize("k", [1, 2])
def test_admission_mid_segment_and_at_boundary(engines, k):
    """A steady request crosses its segment flush while a 4-segment prompt
    is admitted k band steps per chunk: the admission's rounds bracket the
    flush."""
    _, _, seg, vocab = engines
    reqs = _requests([seg - 2, 4 * seg], [2 * seg, 5], vocab, seed=40)
    want, got = _both(engines, reqs, n_slots=2, chunk=2, prefill_groups_per_chunk=k)
    assert got == want
    assert _tokens(got) == _blocking(engines, reqs, n_slots=2, chunk=2)


@pytest.mark.parametrize("budget_segments", [2, 3])
def test_byte_budget_matches_reference(engines, budget_segments):
    """A byte budget below a 5-segment prompt's full-ys prefill: that prompt
    streams in stages that fit (the others keep the default path), with
    the reference's events and the blocking tokens."""
    jeng, teng, seg, vocab = engines
    # each engine's budget is its own estimate of a stage of budget_segments
    # (the port counts what it holds, the reference its drain-padded carry)
    budget = teng.prefill_activation_bytes(budget_segments, stream=True)
    j_budget = jeng.prefill_activation_bytes(budget_segments, stream=True)
    reqs = _requests([5 * seg + 3, seg + 2, 7], [5, 6, 4], vocab, seed=50)
    for k in (0, 2):
        kw = dict(n_slots=2, chunk=3, prefill_groups_per_chunk=k)
        want = _stream(jeng.serve([JRequest(i, p, m) for i, p, m in reqs],
                                  admission_byte_budget=j_budget, **kw))
        got = _stream(teng.serve([Request(i, p, m) for i, p, m in reqs],
                                 admission_byte_budget=budget, **kw))
        assert got == want
        assert _tokens(got) == _blocking(engines, reqs, n_slots=2, chunk=3)
    sched = ContinuousScheduler(teng, admission_byte_budget=budget)
    assert sched._admission_plan(5 * seg + 3)[0]
    assert sched._admission_plan(seg + 2) == (False, None)


@pytest.mark.parametrize("S,B,stream", [(1, 1, True), (3, 1, False), (4, 2, True),
                                        (9, 1, True), (9, 3, False)])
def test_prefill_activation_bytes_matches_reference(engines, S, B, stream):
    """The carry is the reference's estimate less its L - 1 drain-padding
    segments; the whole estimate adds two executor states and the decode
    state (counted here on real tensors) and the widest band's cell peak."""
    jeng, teng = engines[:2]
    cfg = teng.cfg
    L = tmodel.StackLayout.from_config(cfg).n_layers
    T = cfg.armt.segment_len + cfg.armt.num_mem_tokens
    item = teng.params["embed"].element_size()
    seg = B * T * cfg.d_model * item
    carry = teng.prefill_carry_bytes(S, B, stream=stream)
    assert carry == jeng.prefill_activation_bytes(S, B, stream=stream) - (L - 1) * seg

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in jax.tree_util.tree_leaves(tree)
                   if isinstance(t, torch.Tensor))
    state = nbytes(tmodel.init_state(cfg, B, "cpu", teng.params["embed"].dtype))
    dstate = nbytes(teng.decode_state(B))
    width = 3 * cfg.d_ff + 8 * cfg.d_model + (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    cell = B * T * width * item + 3 * state // L
    assert (teng.prefill_activation_bytes(S, B, stream=stream)
            == carry + 2 * state + dstate + min(L, S) * cell)


# ------------------------------------------------------------------ the pipeline

@pytest.mark.parametrize("k,stream,cap", [(1, False, None), (3, True, None),
                                          (None, False, 2), (2, True, 2), (1, True, 1)])
def test_pipeline_result_equals_blocking_prefill(engines, k, stream, cap):
    """start_prefill advanced to the end gives the blocking prefill's
    logits, decode state and position: to the bit at one stage, streaming
    or not (the same band steps). Stages cut by max_stage_segments run
    bands of other widths, which the CPU's batched matmul may round
    differently, so those hold within tolerance here."""
    teng, seg, vocab = engines[1:]
    prompt = torch.from_numpy(np.random.default_rng(60).integers(0, vocab, (1, 3 * seg + 7)))
    logits, dstate, pos, _ = teng.prefill(prompt)
    pipe = teng.start_prefill(prompt, groups_per_call=k, stream=stream,
                              max_stage_segments=cap)
    n = 0
    while not pipe.advance():
        n += 1
    got_logits, got_state, got_pos, _ = pipe.result()
    assert got_pos == pos and pipe.done and n > 0
    n_diag = sum(st[0] == "diag" for st in pipe._stages)
    assert n_diag == (1 if cap is None else -(-3 // cap))
    tol = dict(atol=0, rtol=0) if cap is None else dict(atol=1e-4, rtol=2e-3)
    torch.testing.assert_close(got_logits, logits, **tol)
    for k_ in ("A", "z", "k", "v"):
        torch.testing.assert_close(got_state["pattern"][0][k_], dstate["pattern"][0][k_],
                                   **tol)


def test_pipeline_argument_checks(engines):
    teng, seg = engines[1], engines[2]
    prompt = np.arange(2 * seg + 3)[None]
    for bad in (0, -1, -3):
        with pytest.raises(ValueError):
            teng.start_prefill(prompt, groups_per_call=bad)
    with pytest.raises(ValueError):
        teng.start_prefill(prompt, max_stage_segments=0)
    with pytest.raises(ValueError):
        teng.start_prefill(np.zeros((1, 0), np.int64))


def test_suspended_carry_survives_decode_chunks_in_place(engines):
    """A suspended admission's carry shares no storage with the decode
    pool, and decode chunks that update the pool in place (and garbage
    written over it) between its advances do not change its result."""
    teng, seg, vocab = engines[1:]
    prompt = torch.from_numpy(np.random.default_rng(70).integers(0, vocab, (1, 3 * seg + 4)))
    ref = teng.prefill(prompt)
    sched = ContinuousScheduler(teng, n_slots=2, chunk=2)
    pipe = teng.start_prefill(prompt, groups_per_call=1)
    pipe.advance()
    pool = sched.pool

    def storages(tree):
        return {t.untyped_storage().data_ptr() for t in jax.tree_util.tree_leaves(tree)
                if isinstance(t, torch.Tensor)}
    carry_ptrs = storages((pipe._carry, pipe._xs, pipe._dstate))
    assert not carry_ptrs & storages(pool)
    assert not carry_ptrs & storages(teng.params)
    sched.prog.active.fill_(True)
    while not pipe.done:
        sched.prog.step()
        for leaf in jax.tree_util.tree_leaves((pool["pattern"], pool["prelude"])):
            leaf.fill_(float("nan"))
        pipe.advance()
    logits, dstate, pos, _ = pipe.result()
    torch.testing.assert_close(logits, ref[0], atol=0, rtol=0)
    assert pos == ref[2]
    for k in ("A", "z"):
        torch.testing.assert_close(dstate["pattern"][0][k], ref[1]["pattern"][0][k],
                                   atol=0, rtol=0)


def test_admission_pool_members_never_alias(engines):
    """Three concurrent admissions in one pool: after a pooled round their
    carries are pairwise disjoint in storage, the cells left shrink by what
    the round ran, and each finishes with its blocking prefill's logits."""
    teng, seg, vocab = engines[1:]
    L = tmodel.StackLayout.from_config(teng.cfg).n_layers
    rng = np.random.default_rng(80)
    prompts = [torch.from_numpy(rng.integers(0, vocab, (1, n))) for n in
               (2 * seg + 4, 2 * seg + 1, 2 * seg + 9)]
    refs = [teng.prefill(p) for p in prompts]
    pool = AdmissionPool(teng)
    pipes = [teng.start_prefill(p, groups_per_call=1) for p in prompts]
    for p in pipes:
        pool.add(p)
    assert pool.grid_cells_remaining() == 3 * 2 * L
    buckets = pool.diag_buckets()
    assert list(buckets) == [(1, 1)] and len(buckets[(1, 1)]) == 3
    assert pool.advance_round() == []
    assert pool.grid_cells_remaining() == 3 * (2 * L - 1)

    def storages(carry):
        return {t.untyped_storage().data_ptr() for t in jax.tree_util.tree_leaves(carry)
                if isinstance(t, torch.Tensor)}
    sets = [storages(p._carry) for p in pipes]
    for i in range(3):
        for j in range(i + 1, 3):
            assert not sets[i] & sets[j]
    done = []
    while pool.members:
        done += pool.advance_round()
    assert done == pipes and pool.grid_cells_remaining() == 0
    for p, ref in zip(pipes, refs):
        torch.testing.assert_close(p.result()[0], ref[0], atol=1e-4, rtol=1e-3)
        assert p.result()[2] == ref[2]


def test_admission_pool_pools_members_of_different_grids(engines):
    """Admissions of 2 and 3 segments, one streaming, share one bucket: the
    pooled step runs the rounds in which both are at a diagonal stage as one
    cell call (counted), and each ends with its blocking prefill's logits
    and state (fp32, CPU: a pooled band rounds like a wider band, 1e-4)."""
    from repro_torch.core import diagonal as tdiag
    teng, seg, vocab = engines[1:]
    L = tmodel.StackLayout.from_config(teng.cfg).n_layers
    rng = np.random.default_rng(85)
    prompts = [torch.from_numpy(rng.integers(0, vocab, (1, n)))
               for n in (2 * seg + 3, 3 * seg + 1)]
    refs = [teng.prefill(p) for p in prompts]
    pool = AdmissionPool(teng)
    pipes = [teng.start_prefill(p, groups_per_call=2, stream=s)
             for p, s in zip(prompts, (False, True))]
    for p in pipes:
        pool.add(p)
    assert list(pool.diag_buckets()) == [(1, 2)]
    tdiag.pool_counts.update(steps=0, member_steps=0)
    done = []
    while pool.members:
        done += pool.advance_round()
    # both are live for the shorter grid's 2 + L - 1 steps
    assert tdiag.pool_counts == {"steps": 2 + L - 1, "member_steps": 2 * (2 + L - 1)}
    assert done == pipes
    for p, ref in zip(pipes, refs):
        logits, dstate, pos, _ = p.result()
        torch.testing.assert_close(logits, ref[0], atol=1e-4, rtol=1e-3)
        assert pos == ref[2]
        for k in ("A", "z"):
            torch.testing.assert_close(dstate["pattern"][0][k], ref[1]["pattern"][0][k],
                                       atol=1e-4, rtol=1e-3)


def test_idle_drain_and_admission_windows(engines):
    """With one slot and nothing decoding, pending admissions drain in the
    tight loop; every admission leaves a (start, end) window."""
    teng, seg, vocab = engines[1:]
    reqs = _requests([3 * seg, 2 * seg + 5], [3, 3], vocab, seed=90)
    sched = ContinuousScheduler(teng, n_slots=2, chunk=2, prefill_groups_per_chunk=1)
    events = list(sched.run([Request(i, p, m) for i, p, m in reqs]))
    assert len(events) == 6 and sched.idle_drain_rounds > 0
    assert len(sched.admission_windows) == 2
    assert all(b >= a for a, b in sched.admission_windows)
    first = [e for e in events if e.index == 0]
    assert {e.concurrent_admissions for e in first} == {1, 2}


def test_cache_mode_interleaves_one_tail_piece(engines):
    """serve_mode='cache': an admission is one tail piece (the whole
    prompt), interleaved with the chunks; the events equal the
    reference's cache engine and the port's blocking run."""
    jeng0, teng0, seg, vocab = engines
    jc = j_smoke(ARCH)
    jeng = JEngine(jeng0.params, jc, serve_mode="cache", max_len=96, bucket_prompts=False)
    teng = ServeEngine(teng0.params, teng0.cfg, serve_mode="cache", max_len=96, device="cpu")
    pipe = teng.start_prefill(np.arange(40)[None])
    assert [s[0] for s in pipe._stages] == ["tail"]
    reqs = _requests([40, 9, 33, 20], [8, 5, 9, 6], vocab, seed=95)
    want = _stream(jeng.serve([JRequest(i, p, m) for i, p, m in reqs], n_slots=2, chunk=3))
    got = _stream(teng.serve([Request(i, p, m) for i, p, m in reqs], n_slots=2, chunk=3))
    assert got == want
    blocking = _stream(teng.serve([Request(i, p, m) for i, p, m in reqs], n_slots=2,
                                  chunk=3, prefill_groups_per_chunk=0))
    assert _tokens(got) == _tokens(blocking)


def test_falcon_mamba_interleaved_equals_blocking():
    """falcon-mamba (smoke, fp32): its diagonal stages run the mamba cell,
    which a pooled round advances one member after another; interleaved
    serve at k = 1, 4 and pooled equals blocking, token for token."""
    tc = t_smoke("falcon-mamba-7b")
    tp = tmodel.init_params(tc, 0, device="cpu")
    eng = ServeEngine(tp, tc, device="cpu", max_len=64)
    rng = np.random.default_rng(3)
    reqs = [Request(i, rng.integers(0, tc.vocab, n), m)
            for i, (n, m) in enumerate([(130, 5), (64, 7), (20, 6), (200, 4)])]
    blocking = _tokens(_stream(eng.serve(reqs, n_slots=2, chunk=3,
                                         prefill_groups_per_chunk=0)))
    for kw in (dict(prefill_groups_per_chunk=1), dict(prefill_groups_per_chunk=4),
               dict(prefill_groups_per_chunk=2, fused_admission=True)):
        assert _tokens(_stream(eng.serve(reqs, n_slots=2, chunk=3, **kw))) == blocking, kw
