"""The port's serving path against the JAX reference at smoke size (fp32,
CPU): decode_step and flush_segment in both position forms, and greedy
ServeEngine.generate tokens across a segment flush."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCH = "llama-1b-armt"
# fp32 both sides, a single segment's worth of recurrence
ATOL, RTOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def model():
    jc, tc = j_smoke(ARCH), t_smoke(ARCH)
    jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_state(jstate, tstate):
    ref = state_from_jax(_np(jstate), "cpu")
    for k in ("A", "z", "k", "v"):
        np.testing.assert_allclose(ref["pattern"][0][k].numpy(),
                                   tstate["pattern"][0][k].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    assert np.array_equal(np.asarray(ref["pos"]), np.asarray(tstate["pos"]))


def _random_memory(state, seed):
    """A/z as after some segments, so the read and update are not zero."""
    rng = np.random.default_rng(seed)
    st = state["pattern"][0]
    A = (rng.standard_normal(st["A"].shape) * 0.1).astype(np.float32)
    z = rng.uniform(size=st["z"].shape).astype(np.float32)
    return A, z


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_step_and_flush_match_reference(model, per_slot):
    jc, tc, jp, tp = model
    B, seg = 2, jc.armt.segment_len
    js = jmodel.decode_state_init(jc, B, serve_mode="armt", max_len=64,
                                  dtype=jnp.float32, per_slot_pos=per_slot)
    ts = tmodel.decode_state_init(tc, B, dtype=torch.float32, device="cpu",
                                  per_slot_pos=per_slot)
    A, z = _random_memory(ts, 3)
    js = {**js, "pattern": ({**js["pattern"][0], "A": jnp.asarray(A), "z": jnp.asarray(z)},)}
    ts = {**ts, "pattern": ({**ts["pattern"][0], "A": torch.from_numpy(A),
                             "z": torch.from_numpy(z)},)}
    toks = np.random.default_rng(4).integers(0, jc.vocab, (B, seg))
    # a chunk, then single tokens up to the boundary, then the flush
    jl, js = jmodel.decode_step(jp, jc, js, jnp.asarray(toks[:, :seg - 2]))
    tl, ts = tmodel.decode_step(tp, tc, ts, torch.from_numpy(toks[:, :seg - 2]))
    for t in range(seg - 2, seg):
        jl, js = jmodel.decode_step(jp, jc, js, jnp.asarray(toks[:, t]))
        tl, ts = tmodel.decode_step(tp, tc, ts, torch.from_numpy(toks[:, t]))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL, rtol=RTOL)
    _close_state(js, ts)
    js = jmodel.flush_segment(jp, jc, js)
    ts = tmodel.flush_segment(tp, tc, ts)
    _close_state(js, ts)


@pytest.mark.parametrize("B,n_seg,tail,max_new", [(1, 2, 5, 20), (2, 3, 9, 12)])
def test_generate_tokens_equal_reference(model, B, n_seg, tail, max_new):
    """Greedy tokens equal the reference engine's (its vmap cells, the
    prompt prefilled whole with ``bucket_prompts=False`` as the port
    prefills it: a third of the compile time of its fused, bucketed
    stages); max_new exceeds seg_len - tail, so decode crosses a flush."""
    jc, tc, jp, tp = model
    seg = jc.armt.segment_len
    assert max_new > seg - tail
    prompts = np.random.default_rng(B * 100 + tail).integers(
        0, jc.vocab, (B, n_seg * seg + tail))
    want = JEngine(jp, jc, serve_mode="armt", schedule="diagonal", max_len=256,
                   bucket_prompts=False).generate(jnp.asarray(prompts), max_new)
    got = ServeEngine(tp, tc, device="cpu").generate(prompts, max_new)
    assert got.tokens.shape == (B, max_new) and got.finite
    np.testing.assert_array_equal(np.asarray(want.tokens), got.tokens)
    assert got.prefill_segments == n_seg


def test_prefill_logits_match_reference(model):
    jc, tc, jp, tp = model
    prompts = np.random.default_rng(7).integers(0, jc.vocab,
                                                (2, 2 * jc.armt.segment_len + 3))
    jl, _ = JEngine(jp, jc, serve_mode="armt", max_len=256,
                    bucket_prompts=False).prefill(jnp.asarray(prompts))
    tl, _, pos, _ = ServeEngine(tp, tc, device="cpu").prefill(torch.from_numpy(prompts))
    assert pos == 3
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL, rtol=RTOL)
