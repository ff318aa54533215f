"""The port's continuous-batching front door, ``ServeEngine.serve``, against
the JAX reference's ``serve`` with blocking admission
(``prefill_groups_per_chunk=0``) at smoke size (fp32, CPU): the same event
stream (request, token, index, done) for requests that share slots and
cross segment flushes at different steps, the same rejection codes, and the
host's position mirror agreeing with the device state."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro.serve.scheduler import RequestError as JRequestError  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serve import (ContinuousScheduler, Request, RequestError,  # noqa: E402
                               ServeEngine, StreamEvent)

ARCH = "llama-1b-armt"


@pytest.fixture(scope="module")
def engines():
    jc, tc = j_smoke(ARCH), t_smoke(ARCH)
    jp = jax.jit(lambda key: jmodel.init_params(jc, key))(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jeng = JEngine(jp, jc, serve_mode="armt", schedule="diagonal", max_len=256)
    return jeng, ServeEngine(tp, tc, device="cpu"), jc.armt.segment_len, jc.vocab


def _requests(spec, seg, vocab, seed):
    """spec: (prompt length or None for an empty prompt, max_new,
    session_id) per request."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, n) if n else np.zeros(0, np.int64), m, sid)
            for i, (n, m, sid) in enumerate(spec)]


def _stream(events):
    out = []
    for e in events:
        if isinstance(e, (RequestError, JRequestError)):
            out.append(("error", e.req_id, e.code))
        else:
            out.append((e.req_id, int(e.token), e.index, e.done))
    return out


def _both(engines, reqs, **kw):
    """Both front doors with blocking admission (interleaved admission is
    held against the reference in tests/test_torch_interleave.py)."""
    jeng, teng = engines[:2]
    want = _stream(jeng.serve([JRequest(i, p, m, sid) for i, p, m, sid in reqs],
                              prefill_groups_per_chunk=0, **kw))
    got = list(teng.serve([Request(i, p, m, sid) for i, p, m, sid in reqs],
                          prefill_groups_per_chunk=0, **kw))
    return want, got


def test_serve_matches_reference(engines):
    """5 requests on 2 slots, chunk 4: prompts of 0-3 segments plus tails,
    so admissions land while the other slot decodes and the slots reach
    their segment flushes at different steps."""
    _, _, seg, vocab = engines
    spec = [(seg + 5, 20, None), (2 * seg + 3, 14, None), (7, 25, None),
            (3 * seg, 9, None), (seg + 11, 17, None)]
    reqs = _requests(spec, seg, vocab, seed=0)
    want, got = _both(engines, reqs, n_slots=2, chunk=4)
    assert _stream(got) == want
    done = {e.req_id: e for e in got if e.done}
    assert sorted(done) == list(range(5))
    for i, (_, m, _) in enumerate(spec):
        assert sum(1 for e in got if e.req_id == i) == m
        assert done[i].finite and done[i].ttft_s >= 0 and done[i].tok_s > 0


def test_serve_rejections_match_reference(engines):
    """An invalid max_new, an empty prompt and a session_id (no session
    store) give the reference's invalid_request events in place; the valid
    requests around them are served as the reference serves them."""
    _, _, seg, vocab = engines
    spec = [(seg + 2, 6, None), (5, 0, None), (None, 4, None), (9, 5, "conv-1"),
            (seg - 3, 7, None)]
    want, got = _both(engines, _requests(spec, seg, vocab, seed=1), n_slots=2, chunk=4)
    assert _stream(got) == want
    assert [e.code for e in got if isinstance(e, RequestError)] == ["invalid_request"] * 3


def test_serve_queue_full_matches_reference(engines):
    """Push model: one slot and a backlog of one; the overflow is rejected
    with queue_full at the same points of the stream as the reference."""
    _, _, seg, vocab = engines
    spec = [(seg + 4, 5, None), (6, 3, None), (seg, 4, None), (3, 2, None)]
    want, got = _both(engines, _requests(spec, seg, vocab, seed=2), n_slots=1, chunk=2,
                      max_queue=1)
    assert _stream(got) == want
    assert [e.code for e in got if isinstance(e, RequestError)] == ["queue_full"] * 2


def test_host_position_mirror_matches_device(engines):
    """The scheduler decides flushes from its host mirror of each slot's
    position; after serving, the mirror equals the device state's pos."""
    teng, seg, vocab = engines[1:]
    reqs = _requests([(seg + 3, 11, None), (2 * seg + 9, 30, None), (4, 13, None)],
                     seg, vocab, seed=3)
    sched = ContinuousScheduler(teng, n_slots=2, chunk=3)
    events = list(sched.run([Request(i, p, m) for i, p, m, _ in reqs]))
    assert all(isinstance(e, StreamEvent) for e in events) and len(events) == 54
    assert [s.pos for s in sched.slots] == sched.pool["pos"].tolist()
    assert all(not s.active for s in sched.slots) and len(sched.free) == 2


@pytest.mark.parametrize("kw", [dict(prefill_groups_per_chunk=-2),
                                dict(prefill_groups_per_chunk=-5),
                                dict(max_concurrent_admissions=0),
                                dict(admission_fairness="fifo"),
                                dict(admission_byte_budget=0)])
def test_serve_argument_checks(engines, kw):
    """The reference's argument checks: a group budget below -1 (-1 is a
    whole stage per chunk), no admission slot, an unknown fairness policy
    and an empty byte budget raise."""
    with pytest.raises(ValueError):
        ContinuousScheduler(engines[1], **kw)


@pytest.mark.parametrize("groups", [0, -1, -2])
def test_start_prefill_refuses_group_budget_below_one(engines, groups):
    """start_prefill takes groups_per_call >= 1, or None for a whole stage
    (serve's -1); 0 (blocking) never builds a pipeline."""
    teng, seg = engines[1], engines[2]
    with pytest.raises(ValueError):
        teng.start_prefill(np.arange(2 * seg)[None], groups_per_call=groups)
    assert teng.start_prefill(np.arange(2 * seg)[None], groups_per_call=None).advance()


def test_start_prefill_refuses_stage_cap_below_one(engines):
    teng, seg = engines[1], engines[2]
    for cap in (0, -1):
        with pytest.raises(ValueError):
            teng.start_prefill(np.arange(2 * seg)[None], max_stage_segments=cap)


def test_whole_stage_per_chunk_through_serve(engines):
    """prefill_groups_per_chunk=-1 through serve: each admission's stage in
    one advance, with blocking's tokens."""
    _, teng, seg, vocab = engines
    reqs = _requests([(2 * seg + 3, 5, None), (seg - 1, 4, None)], seg, vocab, seed=4)
    got = _stream(teng.serve([Request(i, p, m) for i, p, m, _ in reqs],
                             prefill_groups_per_chunk=-1))
    want = _stream(teng.serve([Request(i, p, m) for i, p, m, _ in reqs],
                              prefill_groups_per_chunk=0))
    assert sorted(got) == sorted(want)


def test_sequential_schedule_falls_back_to_blocking(engines):
    """The resumable pipeline needs the diagonal schedule: a sequential
    engine admits blocking at any group budget, as the reference does, and
    gives the reference's events."""
    jeng, teng, seg, vocab = engines
    seq = ServeEngine(teng.params, teng.cfg, device="cpu", schedule="sequential")
    reqs = _requests([(seg + 5, 6, None), (2 * seg + 3, 5, None), (7, 4, None)], seg,
                     vocab, seed=5)
    sched = ContinuousScheduler(seq, n_slots=2, chunk=4, prefill_groups_per_chunk=4)
    assert not sched._interleave()
    got = _stream(sched.run([Request(i, p, m) for i, p, m, _ in reqs]))
    assert not sched._adms and sched.idle_drain_rounds == 0
    want = _stream(jeng.serve([JRequest(i, p, m) for i, p, m, _ in reqs], n_slots=2,
                              chunk=4, prefill_groups_per_chunk=0))
    assert got == want
    with pytest.raises(ValueError):
        seq.start_prefill(np.arange(2 * seg)[None])
