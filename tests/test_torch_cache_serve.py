"""The port's full-KV serving (``serve_mode="cache"``, the paper's baseline
comparison) against the JAX reference at smoke size (fp32, CPU): the cache
decode state, ``decode_step`` on one token and on a chunk (scalar and
per-slot positions), greedy ``ServeEngine.generate`` tokens and cache-mode
``serve`` event streams, the max_len refusals, the cache-mode prefill's
logits against the full-attention forward, and a Llama with no ARMT, which
only cache mode can serve.

The port prefills a cache-mode prompt as one chunk; the reference splits it
into power-of-two pieces unless ``bucket_prompts=False`` (prompt bucketing
only bounded JAX's compiles and is not ported), so the reference engines
here are built with ``bucket_prompts=False``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro.serve.scheduler import RequestError as JRequestError  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import Request, RequestError, ServeEngine  # noqa: E402

ARCH = "llama-1b-armt"
# fp32 both sides (as tests/test_torch_serve.py)
ATOL, RTOL = 1e-4, 1e-3
MAX_LEN = 96


def _build(jc, tc):
    jp = jax.jit(lambda key: jmodel.init_params(jc, key))(jax.random.PRNGKey(0))
    return jc, tc, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def model():
    return _build(j_smoke(ARCH), t_smoke(ARCH))


@pytest.fixture(scope="module")
def plain_llama():
    """llama-1b-armt's smoke widths with no ARMT: the full-attention
    baseline model."""
    return _build(dataclasses.replace(j_smoke(ARCH), armt=None),
                  dataclasses.replace(t_smoke(ARCH), armt=None))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_cache(jstate, tstate):
    want = state_from_jax(_np(jstate), "cpu")
    assert set(tstate["pattern"][0]) == set(want["pattern"][0]) == {"k", "v"}
    for k in ("k", "v"):
        np.testing.assert_allclose(want["pattern"][0][k].numpy(),
                                   tstate["pattern"][0][k].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    assert np.array_equal(np.asarray(want["pos"]), np.asarray(tstate["pos"]))


def test_cache_decode_state_matches_reference(model):
    jc, tc = model[:2]
    js = jmodel.decode_state_init(jc, 3, serve_mode="cache", max_len=MAX_LEN,
                                  dtype=jnp.float32)
    ts = tmodel.decode_state_init(tc, 3, dtype=torch.float32, device="cpu",
                                  serve_mode="cache", max_len=MAX_LEN)
    want = _np(js["pattern"][0])
    assert set(ts["pattern"][0]) == set(want) == {"k", "v"}
    for k in want:
        assert tuple(ts["pattern"][0][k].shape) == want[k].shape
        assert tuple(ts["pattern"][0][k].shape)[2] == MAX_LEN
    with pytest.raises(ValueError, match="max_len"):
        tmodel.decode_state_init(tc, 1, dtype=torch.float32, device="cpu",
                                 serve_mode="cache")
    with pytest.raises(ValueError, match="serve_mode"):
        tmodel.decode_state_init(tc, 1, dtype=torch.float32, device="cpu",
                                 serve_mode="full", max_len=MAX_LEN)


@pytest.mark.parametrize("per_slot", [False, True])
def test_cache_decode_step_matches_reference(model, per_slot):
    """A 20-token chunk from position 0, then single tokens: the logits, the
    caches and pos agree with the reference's cache-mode decode_step."""
    jc, tc, jp, tp = model
    B = 2
    js = jmodel.decode_state_init(jc, B, serve_mode="cache", max_len=MAX_LEN,
                                  dtype=jnp.float32, per_slot_pos=per_slot)
    ts = tmodel.decode_state_init(tc, B, dtype=torch.float32, device="cpu",
                                  serve_mode="cache", max_len=MAX_LEN,
                                  per_slot_pos=per_slot)
    toks = np.random.default_rng(11).integers(0, jc.vocab, (B, 24))
    jl, js = jmodel.decode_step(jp, jc, js, jnp.asarray(toks[:, :20]), serve_mode="cache")
    tl, ts = tmodel.decode_step(tp, tc, ts, torch.from_numpy(toks[:, :20]),
                                serve_mode="cache")
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL, rtol=RTOL)
    _close_cache(js, ts)
    for t in range(20, 24):
        jl, js = jmodel.decode_step(jp, jc, js, jnp.asarray(toks[:, t]), serve_mode="cache")
        tl, ts = tmodel.decode_step(tp, tc, ts, torch.from_numpy(toks[:, t]),
                                    serve_mode="cache")
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL, rtol=RTOL)
    _close_cache(js, ts)
    assert np.asarray(ts["pos"]).reshape(-1).tolist() == [24] * (B if per_slot else 1)


@pytest.mark.parametrize("B,P,max_new", [(1, 37, 20), (2, 50, 12), (1, 16, 30)])
def test_cache_generate_tokens_equal_reference(model, B, P, max_new):
    jc, tc, jp, tp = model
    prompts = np.random.default_rng(B * 7 + P).integers(0, jc.vocab, (B, P))
    want = JEngine(jp, jc, serve_mode="cache", max_len=MAX_LEN,
                   bucket_prompts=False).generate(jnp.asarray(prompts), max_new)
    got = ServeEngine(tp, tc, serve_mode="cache", max_len=MAX_LEN,
                      device="cpu").generate(prompts, max_new)
    assert got.tokens.shape == (B, max_new) and got.finite
    np.testing.assert_array_equal(np.asarray(want.tokens), got.tokens)


def test_cache_prefill_logits_match_full_mode(model):
    """Two code paths for one function: the cache-mode prefill (one
    decode_step chunk from position 0) and forward_hidden(mode='full') on
    the fused cell, and the reference's cache-mode prefill."""
    jc, tc, jp, tp = model
    prompts = np.random.default_rng(12).integers(0, jc.vocab, (2, 45))
    logits, dstate, pos, _ = ServeEngine(tp, tc, serve_mode="cache", max_len=MAX_LEN,
                                         device="cpu").prefill(torch.from_numpy(prompts))
    assert pos == 45 and dstate["pos"] == 45
    h, _ = tmodel.forward_hidden(tp, tc, torch.from_numpy(prompts), mode="full")
    torch.testing.assert_close(logits, tmodel.last_logits(tp, tc, h), atol=ATOL, rtol=RTOL)
    jl = JEngine(jp, jc, serve_mode="cache", max_len=MAX_LEN,
                 bucket_prompts=False)._prefill(jnp.asarray(prompts))[0]
    np.testing.assert_allclose(np.asarray(jl), logits.numpy(), atol=ATOL, rtol=RTOL)


def _stream(events):
    out = []
    for e in events:
        if isinstance(e, (RequestError, JRequestError)):
            out.append(("error", e.req_id, e.code, e.message))
        else:
            out.append((e.req_id, int(e.token), e.index, e.done))
    return out


def test_cache_serve_matches_reference(model):
    """6 requests on 2 slots, chunk 4, prompts of 5-80 tokens; one request
    whose prompt and new tokens exceed max_len is rejected in place with the
    reference's invalid_request event and message."""
    jc, tc, jp, tp = model
    rng = np.random.default_rng(13)
    spec = [(30, 20), (7, 25), (80, 9), (90, 10), (45, 17), (5, 31)]
    reqs = [(i, rng.integers(0, jc.vocab, n), m) for i, (n, m) in enumerate(spec)]
    jeng = JEngine(jp, jc, serve_mode="cache", max_len=MAX_LEN, bucket_prompts=False)
    want = _stream(jeng.serve([JRequest(i, p, m) for i, p, m in reqs], n_slots=2, chunk=4,
                              prefill_groups_per_chunk=0))
    got = list(ServeEngine(tp, tc, serve_mode="cache", max_len=MAX_LEN, device="cpu")
               .serve([Request(i, p, m) for i, p, m in reqs], n_slots=2, chunk=4))
    assert _stream(got) == want
    errors = [e for e in got if isinstance(e, RequestError)]
    assert [(e.req_id, e.code) for e in errors] == [(3, "invalid_request")]
    assert "exceeds max_len" in errors[0].message
    for i, (_, m) in enumerate(spec):
        if i != 3:
            assert sum(1 for e in got if not isinstance(e, RequestError)
                       and e.req_id == i) == m


def test_cache_mode_refuses_past_max_len(model):
    """generate refuses prompt + max_new > max_len with the reference's
    message; at exactly max_len it runs."""
    jc, tc, jp, tp = model
    eng = ServeEngine(tp, tc, serve_mode="cache", max_len=MAX_LEN, device="cpu")
    prompts = np.random.default_rng(14).integers(0, jc.vocab, (1, 90))
    jeng = JEngine(jp, jc, serve_mode="cache", max_len=MAX_LEN, bucket_prompts=False)
    with pytest.raises(ValueError) as want:
        jeng.generate(jnp.asarray(prompts), 7)
    with pytest.raises(ValueError) as got:
        eng.generate(prompts, 7)
    assert str(got.value) == str(want.value)
    assert eng.generate(prompts, 6).tokens.shape == (1, 6)
    with pytest.raises(ValueError, match="max_len"):
        eng.prefill(torch.zeros(1, MAX_LEN + 1, dtype=torch.long))


def test_engine_refusals(model, plain_llama):
    """The reference's refusals: an unknown serve_mode; 'armt' mode for a
    model with neither ARMT nor recurrent layers; and an unknown schedule."""
    tc, tp = model[1], model[3]
    with pytest.raises(ValueError, match="serve_mode"):
        ServeEngine(tp, tc, serve_mode="kv", device="cpu")
    with pytest.raises(ValueError, match="schedule"):
        ServeEngine(tp, tc, schedule="banded", device="cpu")
    pc, pp = plain_llama[1], plain_llama[3]
    with pytest.raises(ValueError, match="serve_mode='cache'"):
        ServeEngine(pp, pc, device="cpu")
    ServeEngine(pp, pc, serve_mode="cache", max_len=MAX_LEN, device="cpu")


def test_plain_llama_cache_generate_matches_reference(plain_llama):
    """The full-attention baseline model (no ARMT): init_params makes no
    memory weights, and cache-mode generate gives the reference's tokens."""
    jc, tc, jp, tp = plain_llama
    assert "mem" not in tp["pattern"][0] and "mem_tokens" not in tp
    mine = tmodel.init_params(tc, 0, device="cpu")
    assert set(mine["pattern"][0]) == set(tp["pattern"][0])
    prompts = np.random.default_rng(15).integers(0, jc.vocab, (2, 33))
    want = JEngine(jp, jc, serve_mode="cache", max_len=MAX_LEN,
                   bucket_prompts=False).generate(jnp.asarray(prompts), 15)
    got = ServeEngine(tp, tc, serve_mode="cache", max_len=MAX_LEN,
                      device="cpu").generate(prompts, 15)
    np.testing.assert_array_equal(np.asarray(want.tokens), got.tokens)


_REF = {}


@pytest.mark.parametrize("schedule", ["diagonal", "sequential"])
def test_armt_engine_prefill_schedule(model, schedule):
    """ServeEngine(schedule=...): the ARMT prefill under either executor on
    the fused cell gives the reference's greedy tokens (the reference's,
    computed once, on its vmap cells with the prompt prefilled whole, as
    the port prefills it)."""
    jc, tc, jp, tp = model
    seg = jc.armt.segment_len
    prompts = np.random.default_rng(16).integers(0, jc.vocab, (1, 3 * seg + 5))
    if "prefill_schedule" not in _REF:
        _REF["prefill_schedule"] = JEngine(
            jp, jc, serve_mode="armt", schedule="diagonal", max_len=256,
            bucket_prompts=False).generate(jnp.asarray(prompts), 14)
    want = _REF["prefill_schedule"]
    got = ServeEngine(tp, tc, schedule=schedule, device="cpu").generate(prompts, 14)
    np.testing.assert_array_equal(np.asarray(want.tokens), got.tokens)
