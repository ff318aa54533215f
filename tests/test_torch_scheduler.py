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
    jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
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
    jeng, teng = engines[:2]
    want = _stream(jeng.serve([JRequest(i, p, m, sid) for i, p, m, sid in reqs],
                              prefill_groups_per_chunk=0, **kw))
    got = list(teng.serve([Request(i, p, m, sid) for i, p, m, sid in reqs], **kw))
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


def test_serve_refuses_interleaved_admission(engines):
    teng = engines[1]
    for groups in (1, 4):
        with pytest.raises(ValueError):
            teng.serve([], prefill_groups_per_chunk=groups)
