"""The port's decode layer against the JAX reference at smoke size (fp32,
CPU): decode attention's plain version against the reference's Pallas
kernel in interpret mode and its oracle (ragged per-row lengths, sliding
window, GQA), the single-token decode step through the kernel entry point,
and the per-slot merge and masked segment flush with slots at different
positions."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

ARCH = "llama-1b-armt"
# attention alone: fp32 softmax and products, summation order only
ATTN_ATOL = 1e-5
# a full decode step / flush through the stack (as tests/test_torch_serve.py)
ATOL, RTOL = 1e-4, 1e-3


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# (B, Hq, Hkv, S, hd, lengths, window)
DECODE_CASES = [
    (3, 4, 2, 40, 16, (40, 17, 1), 0),      # GQA, lengths S, mid and 1
    (2, 8, 2, 37, 8, (30, 5), 6),           # ragged S, sliding window
    (3, 4, 4, 24, 8, (24, 3, 12), 0),       # rep 1
    (2, 4, 1, 29, 16, (29, 2), 40),         # MQA, window wider than the prefix
]


@pytest.mark.parametrize("B,Hq,Hkv,S,hd,lens,window", DECODE_CASES)
def test_decode_attention_plain_matches_reference(B, Hq, Hkv, S, hd, lens, window):
    rng = np.random.default_rng(S + hd)
    q, k, v = _f(rng, B, Hq, hd), _f(rng, B, S, Hkv, hd), _f(rng, B, S, Hkv, hd)
    lengths = np.asarray(lens, np.int32)
    got = ref.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), torch.from_numpy(lengths),
                                   window=window).numpy()
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths))
    want_ref = jref.decode_attention_ref(*args, window=window)
    np.testing.assert_allclose(np.asarray(want_ref), got, atol=ATTN_ATOL, rtol=0)
    want_kernel = jops.decode_attention(*args, window=window, use_kernel=True,
                                        interpret=True)
    np.testing.assert_allclose(np.asarray(want_kernel), got, atol=ATTN_ATOL, rtol=0)


def test_decode_attention_entry_point_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(_f(rng, *s)) for s in
               [(2, 4, 8), (2, 10, 2, 8), (2, 10, 2, 8)])
    lengths = torch.tensor([10, 4], dtype=torch.int32)
    before = tda.launches
    got = ops.decode_attention(q, k, v, lengths, window=3)
    assert tda.launches == before
    torch.testing.assert_close(got, ref.decode_attention_ref(q, k, v, lengths, window=3),
                               rtol=0, atol=0)


def test_decode_attention_refuses_other_devices():
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        tda.decode_attention(torch.empty(2, 4, 8, **meta), torch.empty(2, 6, 2, 8, **meta),
                             torch.empty(2, 6, 2, 8, **meta),
                             torch.empty(2, dtype=torch.int32, **meta))


# ------------------------------------------------------------ decode state
@pytest.fixture(scope="module")
def model():
    jc, tc = j_smoke(ARCH), t_smoke(ARCH)
    jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_state(jstate, tstate):
    want = state_from_jax(_np(jstate), "cpu")
    for k in ("A", "z", "k", "v"):
        np.testing.assert_allclose(want["pattern"][0][k].numpy(),
                                   tstate["pattern"][0][k].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    np.testing.assert_array_equal(np.asarray(want["pos"]), tstate["pos"].numpy())


def _slots_at(jc, tc, jp, tp, pos, seed):
    """Both packages' per-slot decode states with random memory, each slot
    fed ``pos[b]`` tokens one step at a time through the packed step,
    rows that are done frozen with mask_decode_state, as the scheduler
    does."""
    B = len(pos)
    js = jmodel.decode_state_init(jc, B, serve_mode="armt", max_len=64,
                                  dtype=jnp.float32, per_slot_pos=True)
    ts = tmodel.decode_state_init(tc, B, dtype=torch.float32, device="cpu",
                                  per_slot_pos=True)
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal(js["pattern"][0]["A"].shape) * 0.1).astype(np.float32)
    z = rng.uniform(size=js["pattern"][0]["z"].shape).astype(np.float32)
    js = {**js, "pattern": ({**js["pattern"][0], "A": jnp.asarray(A), "z": jnp.asarray(z)},)}
    ts = {**ts, "pattern": ({**ts["pattern"][0], "A": torch.from_numpy(A),
                             "z": torch.from_numpy(z)},)}
    toks = rng.integers(0, jc.vocab, (max(pos), B))
    step = jax.jit(lambda p, s, t: jmodel.decode_step(p, jc, s, t))
    for t in range(max(pos)):
        mask = np.asarray([t < p for p in pos])
        jl, jn = step(jp, js, jnp.asarray(toks[t]))
        tl, tn = tmodel.decode_step(tp, tc, ts, torch.from_numpy(toks[t]))
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL, rtol=RTOL)
        js = jmodel.mask_decode_state(jnp.asarray(mask), jn, js)
        ts = tmodel.mask_decode_state(torch.from_numpy(mask), tn, ts)
    return js, ts


def test_per_slot_decode_and_mask_match_reference(model):
    """Slots at positions 9, 4 and 15 of a 16-token segment: the packed
    single-token step (the decode kernel's entry point on the CPU) and the
    per-row freeze agree with JAX, and frozen rows keep their positions."""
    jc, tc, jp, tp = model
    js, ts = _slots_at(jc, tc, jp, tp, (9, 4, 15), seed=5)
    _close_state(js, ts)
    assert ts["pos"].tolist() == [9, 4, 15]


def test_masked_flush_matches_reference(model):
    """flush_segment(slot_mask=) flushes exactly the masked slots: their
    memory is updated and their cache and pos reset, while the other rows,
    at other positions, keep their state bit for bit."""
    jc, tc, jp, tp = model
    seg = jc.armt.segment_len
    js, ts = _slots_at(jc, tc, jp, tp, (seg, 7, seg, 3), seed=6)
    mask = np.asarray([True, False, True, False])
    jf = jmodel.flush_segment(jp, jc, js, slot_mask=jnp.asarray(mask))
    tf = tmodel.flush_segment(tp, tc, ts, slot_mask=torch.from_numpy(mask))
    _close_state(jf, tf)
    assert tf["pos"].tolist() == [0, 7, 0, 3]
    for key in ("A", "z", "k", "v"):
        kept, was = tf["pattern"][0][key][:, ~mask], ts["pattern"][0][key][:, ~mask]
        assert torch.equal(kept, was), key
    assert not torch.equal(tf["pattern"][0]["A"][:, mask], ts["pattern"][0]["A"][:, mask])
    assert not tf["pattern"][0]["k"][:, mask].any()


def test_masked_flush_needs_per_slot_pos(model):
    jc, tc, jp, tp = model
    st = tmodel.decode_state_init(tc, 2, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="per-slot"):
        tmodel.flush_segment(tp, tc, st, slot_mask=torch.tensor([True, False]))
