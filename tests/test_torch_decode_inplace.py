"""The port's in-place decode state (the counterpart of the reference's
donated loops) at smoke size, fp32, on the CPU: ``decode_step_`` and
``flush_segment_`` against the JAX ``decode_step``/``flush_segment`` over
steps that cross a flush; the in-place step and flush equal, to the bit, to
the functional ones; masked steps and flushes leaving every leaf of the
other rows bit-exact; the state's buffers keeping their addresses; the
sequential executor in place against the layer-stacking loop it replaced;
the decode program (run uncaptured, as the CPU always does) against the
step it wraps; and the capture helper's launch accounting with a fake
kernel wrapper."""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.core import capture  # noqa: E402
from repro_torch.core.schedule import StackLayout  # noqa: E402
from repro_torch.core.sequential import (clone_state, layer_slice, run_sequential,  # noqa: E402
                                         run_sequential_, stack_layers)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

# a full decode step / flush through the stack (as tests/test_torch_decode.py)
ATOL, RTOL = 1e-4, 1e-3


@pytest.fixture(scope="module", params=["llama-1b-armt", "falcon-mamba-7b"])
def model(request):
    jc, tc = j_smoke(request.param), t_smoke(request.param)
    jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def llama():
    jc, tc = j_smoke("llama-1b-armt"), t_smoke("llama-1b-armt")
    jp = jmodel.init_params(jc, jax.random.PRNGKey(1))
    return jc, tc, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _leaves(state):
    """{name: tensor} of every leaf of a decode state, pos included."""
    out = {"pos": state["pos"]}
    for part in ("prelude", "pattern"):
        for i, d in enumerate(state[part]):
            out.update({f"{part}{i}.{k}": v for k, v in d.items()})
    return out


def _bits_equal(a, b):
    if not isinstance(a, torch.Tensor):
        return a == b
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert _bits_equal(la[k], lb[k]), k


def _states(jc, tc, B, seed, *, pos, per_slot=True):
    """Both packages' decode states with random memory (A/z as after some
    segments, or a random SSM state), each row at ``pos[b]`` (all equal
    without per_slot) with its cache filled below it."""
    js = jmodel.decode_state_init(jc, B, serve_mode="armt", max_len=64,
                                  dtype=jnp.float32, per_slot_pos=per_slot)
    rng = np.random.default_rng(seed)
    pat = dict(js["pattern"][0])
    for k, v in pat.items():
        shape = np.asarray(v).shape
        if k == "z":
            pat[k] = jnp.asarray(rng.uniform(size=shape).astype(np.float32))
        elif k in ("k", "v"):
            val = rng.standard_normal(shape).astype(np.float32)
            rows = np.arange(shape[2])[None, None, :, None, None]
            limit = np.asarray(pos)[None, :, None, None, None]
            pat[k] = jnp.asarray(np.where(rows < limit, val, 0.0).astype(np.float32))
        else:
            pat[k] = jnp.asarray((rng.standard_normal(shape) * 0.1).astype(np.float32))
    js = {**js, "pattern": (pat,),
          "pos": jnp.asarray(pos if per_slot else pos[0], jnp.int32)}
    return js, state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")


def _close(jstate, tstate):
    want = state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    for name, leaf in _leaves(want).items():
        got = _leaves(tstate)[name]
        if name == "pos":
            assert np.array_equal(np.asarray(leaf), np.asarray(got))
        else:
            np.testing.assert_allclose(leaf.numpy(), got.numpy(), atol=ATOL, rtol=RTOL,
                                       err_msg=name)


# ------------------------------------------------------------ against JAX
@pytest.mark.parametrize("per_slot", [False, True])
def test_inplace_step_and_flush_match_reference(model, per_slot):
    """A chunk, single tokens across the segment boundary with the flush
    where pos reaches seg_len, and single tokens after it: the in-place
    step and flush against the reference's functional ones."""
    jc, tc, jp, tp = model
    B = 2
    seg = jc.armt.segment_len if jc.armt is not None else 16
    js, ts = _states(jc, tc, B, seed=3, per_slot=per_slot, pos=[0] * B)
    toks = np.random.default_rng(4).integers(0, jc.vocab, (B, seg + 4))
    step = jax.jit(lambda p, s, t: jmodel.decode_step(p, jc, s, t))
    jl, js = jmodel.decode_step(jp, jc, js, jnp.asarray(toks[:, :seg - 3]))
    tl = tmodel.decode_step_(tp, tc, ts, torch.from_numpy(toks[:, :seg - 3]))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL, rtol=RTOL)
    for t in range(seg - 3, seg + 4):
        jl, js = step(jp, js, jnp.asarray(toks[:, t]))
        tl = tmodel.decode_step_(tp, tc, ts, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=ATOL, rtol=RTOL)
        if jc.armt is not None and t == seg - 1:
            _close(js, ts)
            js = jmodel.flush_segment(jp, jc, js)
            tmodel.flush_segment_(tp, tc, ts)
            _close(js, ts)
    _close(js, ts)


# ------------------------------------------------------------ in place = functional
@pytest.mark.parametrize("serve_mode", ["armt", "cache"])
def test_inplace_step_equals_functional_to_the_bit(model, serve_mode):
    jc, tc, jp, tp = model        # a pure-SSM model's state is the same in both modes
    B = 3
    state = tmodel.decode_state_init(tc, B, dtype=torch.float32, device="cpu",
                                     serve_mode=serve_mode, max_len=64, per_slot_pos=True)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, tc.vocab, (B, 9)))
    fn_state = clone_state(state)
    for t in range(toks.shape[1]):
        want, fn_state = tmodel.decode_step(tp, tc, fn_state, toks[:, t],
                                            serve_mode=serve_mode)
        got = tmodel.decode_step_(tp, tc, state, toks[:, t], serve_mode=serve_mode)
        assert _bits_equal(got, want)
        _assert_same_state(state, fn_state)
    if tc.armt is not None and serve_mode == "armt":
        want = tmodel.flush_segment(tp, tc, fn_state)
        tmodel.flush_segment_(tp, tc, state)
        _assert_same_state(state, want)
        assert state["pos"].tolist() == [0] * B


def test_functional_step_leaves_its_input(llama):
    jc, tc, jp, tp = llama
    _, ts = _states(jc, tc, 2, seed=6, pos=[3, 5])
    before = clone_state(ts)
    tmodel.decode_step(tp, tc, ts, torch.tensor([1, 2]))
    tmodel.flush_segment(tp, tc, ts, slot_mask=torch.tensor([True, False]))
    _assert_same_state(ts, before)


# ------------------------------------------------------------ masks
def test_masked_step_freezes_inactive_rows(model):
    """decode_step_(mask=): inactive rows keep every leaf (caches, A/z or h
    and conv) and pos to the bit; active rows equal an unmasked step's,
    also to the bit."""
    jc, tc, jp, tp = model
    B, mask = 4, torch.tensor([True, False, True, False])
    seg = jc.armt.segment_len if jc.armt is not None else 16
    _, ts = _states(jc, tc, B, seed=7, pos=[2, 5, seg - 1, seg])
    ref = clone_state(ts)
    tok = torch.from_numpy(np.random.default_rng(8).integers(0, tc.vocab, B))
    full = clone_state(ts)
    want = tmodel.decode_step_(tp, tc, full, tok)
    got = tmodel.decode_step_(tp, tc, ts, tok, mask=mask)
    assert _bits_equal(got[mask], want[mask])
    for name, leaf in _leaves(ts).items():
        axis = 0 if name == "pos" else 1
        keep, was = leaf.index_select(axis, torch.tensor([1, 3])), \
            _leaves(ref)[name].index_select(axis, torch.tensor([1, 3]))
        assert _bits_equal(keep, was), name
        on, want_on = leaf.index_select(axis, torch.tensor([0, 2])), \
            _leaves(full)[name].index_select(axis, torch.tensor([0, 2]))
        assert _bits_equal(on, want_on), name
    assert ts["pos"].tolist() == [3, 5, seg, seg]


def test_masked_flush_freezes_other_rows(llama):
    """flush_segment_(mask=): the masked rows equal an unmasked flush's to
    the bit; the others keep every leaf, their cache rows past pos (where
    the memory tokens are written for every row) included."""
    jc, tc, jp, tp = llama
    seg = jc.armt.segment_len
    mask = torch.tensor([True, False, True, False])
    _, ts = _states(jc, tc, 4, seed=9, pos=[seg, 7, seg, 3])
    ref = clone_state(ts)
    full = clone_state(ts)
    tmodel.flush_segment_(tp, tc, full)
    tmodel.flush_segment_(tp, tc, ts, mask=mask)
    for name, leaf in _leaves(ts).items():
        axis = 0 if name == "pos" else 1
        for rows, want in (([1, 3], ref), ([0, 2], full)):
            idx = torch.tensor(rows)
            assert _bits_equal(leaf.index_select(axis, idx),
                               _leaves(want)[name].index_select(axis, idx)), (name, rows)
    assert ts["pos"].tolist() == [0, 7, 0, 3]
    assert not ts["pattern"][0]["k"][:, mask].any()


def test_masked_flush_matches_masked_reference(llama):
    jc, tc, jp, tp = llama
    seg = jc.armt.segment_len
    mask = np.array([False, True, True])
    js, ts = _states(jc, tc, 3, seed=10, pos=[4, seg, seg])
    js = jmodel.flush_segment(jp, jc, js, slot_mask=jnp.asarray(mask))
    tmodel.flush_segment_(tp, tc, ts, mask=torch.from_numpy(mask))
    _close(js, ts)


def test_mask_needs_per_slot_pos(llama):
    jc, tc, jp, tp = llama
    st = tmodel.decode_state_init(tc, 2, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="per-slot"):
        tmodel.decode_step_(tp, tc, st, torch.tensor([1, 2]), mask=torch.tensor([True, False]))
    with pytest.raises(ValueError, match="per-slot"):
        tmodel.flush_segment_(tp, tc, st, mask=torch.tensor([True, False]))


# ------------------------------------------------------------ static buffers
def test_state_buffers_keep_their_addresses(model):
    """Steps, masked steps and flushes write into the state's own buffers:
    every leaf (KV caches, A/z; h and the conv tail) and pos keep their
    data_ptr, as a captured graph needs."""
    jc, tc, jp, tp = model
    seg = jc.armt.segment_len if jc.armt is not None else 16
    _, ts = _states(jc, tc, 2, seed=11, pos=[seg - 2, 1])
    ptrs = {k: v.data_ptr() for k, v in _leaves(ts).items()}
    rng = np.random.default_rng(12)
    for t in range(4):
        tok = torch.from_numpy(rng.integers(0, tc.vocab, 2))
        tmodel.decode_step_(tp, tc, ts, tok, mask=torch.tensor([True, t % 2 == 0]))
        if tc.armt is not None and t == 1:
            tmodel.flush_segment_(tp, tc, ts, mask=torch.tensor([True, False]))
    assert {k: v.data_ptr() for k, v in _leaves(ts).items()} == ptrs


# ------------------------------------------------------------ the sequential executor
def _stacking_loop(layout, params, state0, segments, apply_block):
    """The functional executor the in-place one replaced: every layer's new
    state collected, then stacked."""
    pattern = [[layer_slice(st, j) for j in range(layout.n_super)]
               for st in state0["pattern"]]
    ys = []
    for x in segments:
        for j in range(layout.n_super):
            for p, t in enumerate(layout.pattern):
                x, pattern[p][j] = apply_block(
                    t, layer_slice(params["pattern"][p], j), x, pattern[p][j])
        ys.append(x)
    return torch.stack(ys), {"prelude": (), "pattern": tuple(stack_layers(s) for s in pattern)}


@pytest.mark.parametrize("fused", [False, True])
def test_sequential_inplace_equals_functional_to_the_bit(model, fused):
    jc, tc, jp, tp = model
    from repro_torch.models.blocks import make_apply_block
    from repro_torch.models.grouped_blocks import make_grouped_apply
    layout = StackLayout.from_config(tc)
    apply = (tmodel._one_layer_cell(make_grouped_apply(tc)) if fused
             else make_apply_block(tc))
    seg = 16
    toks = torch.from_numpy(np.random.default_rng(13).integers(0, tc.vocab, (2, 3 * seg)))
    x = tmodel.embed_segments(tp, tc, toks, seg)
    state0 = tmodel.init_state(tc, 2, "cpu")
    _, warm = run_sequential(layout, tp, state0, x[:1], apply)     # non-zero memory
    want_ys, want = _stacking_loop(layout, tp, warm, x, apply)
    ys, fin = run_sequential(layout, tp, warm, x, apply)
    assert _bits_equal(ys, want_ys)
    _assert_same_state({**fin, "pos": 0}, {**want, "pos": 0})
    state = clone_state(warm)
    ptrs = [t.data_ptr() for t in state["pattern"][0].values()]
    ys_ = run_sequential_(layout, tp, state, x, apply)
    assert _bits_equal(ys_, want_ys)
    _assert_same_state({**state, "pos": 0}, {**want, "pos": 0})
    assert [t.data_ptr() for t in state["pattern"][0].values()] == ptrs


def test_segment_program_equals_sequential_uncaptured(llama):
    """The sequential schedule's segment body as a program (static input
    segment and state), run uncaptured, against the functional executor
    (what forward_hidden runs on the CPU) to the bit."""
    from repro_torch.models.grouped_blocks import make_grouped_apply
    jc, tc, jp, tp = llama
    seg = tc.armt.segment_len
    toks = torch.from_numpy(np.random.default_rng(14).integers(0, tc.vocab, (2, 3 * seg)))
    x = tmodel.embed_segments(tp, tc, toks, seg)
    state0 = tmodel.init_state(tc, 2, "cpu")
    _, warm = run_sequential(StackLayout.from_config(tc), tp, state0, x[:1],
                             tmodel._one_layer_cell(make_grouped_apply(tc)))
    want_ys, want = run_sequential(StackLayout.from_config(tc), tp, warm, x,
                                   tmodel._one_layer_cell(make_grouped_apply(tc)))
    prog = tmodel.SegmentProgram(tp, tc, x.shape[1:], x.dtype, "cpu", capture=False)
    ys, fin = prog.run(x, warm)
    assert _bits_equal(ys, want_ys)
    _assert_same_state({**fin, "pos": 0}, {**want, "pos": 0})


# ------------------------------------------------------------ decode programs
def test_decode_program_step_equals_inplace_step(llama):
    """The engine's decode program (uncaptured on the CPU): its step is the
    masked in-place step plus the greedy pick, its flush the masked flush;
    the tokens of inactive rows stay."""
    jc, tc, jp, tp = llama
    seg = tc.armt.segment_len
    eng = ServeEngine(tp, tc, device="cpu")
    prog = eng.program(3, "serve")
    prog.prepare()
    _, ts = _states(jc, tc, 3, seed=15, pos=[seg - 1, 2, 6])
    tmodel.copy_state_(prog.state, ts)
    prog.state["pos"].copy_(ts["pos"])
    prog.tok.copy_(torch.tensor([5, 6, 7]))
    prog.active.copy_(torch.tensor([True, True, False]))
    logits = prog.step()
    want = tmodel.decode_step_(tp, tc, ts, torch.tensor([5, 6, 7]),
                               mask=torch.tensor([True, True, False]))
    assert _bits_equal(logits, want)
    assert prog.tok.tolist() == want.argmax(-1)[:2].tolist() + [7]
    prog.boundary.copy_(torch.tensor([True, False, False]))
    prog.flush()
    tmodel.flush_segment_(tp, tc, ts, mask=torch.tensor([True, False, False]))
    _assert_same_state(prog.state, ts)


# ------------------------------------------------------------ launch accounting
def test_capture_accounting_with_a_fake_kernel_wrapper():
    """What a capture counts is taken back and recorded; a replay adds the
    record: the counters read as if each replay had launched eagerly."""
    fake = types.ModuleType("fake_kernel")
    fake.launches = 0
    fake.other = 0
    build.count_launches(fake, "launches", "other")

    def wrapper(x):
        fake.launches += 1
        return x * 2

    try:
        assert build.launch_counts()[(fake, "launches")] == 0
        wrapper(torch.ones(2))                          # an eager launch counts
        with capture.uncounted() as counted:
            wrapper(torch.ones(2))
            wrapper(torch.ones(2))
        assert fake.launches == 1 and counted == {(fake, "launches"): 2}
        for _ in range(3):
            capture.add_counts(counted)
        assert (fake.launches, fake.other) == (7, 0)
        prog = capture.Program(lambda: wrapper(torch.ones(2)), "cpu", capture=False)
        prog()
        assert fake.launches == 8                       # uncaptured: counted as run
        with pytest.raises(ValueError, match="CUDA"):
            capture.Program(lambda: None, "cpu", capture=True)
    finally:
        build._COUNTED.pop("fake_kernel")
