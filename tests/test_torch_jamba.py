"""The hybrid jamba stack (jamba-1.5-large-398b: attention without rotary,
Mamba layers with a dense FFN, Mamba layers with a MoE FFN, in a pattern of
8 positions) against the JAX reference at smoke size (fp32, CPU): the
config and parameter tree, the three blocks, the fused mamba cells against
the plain block slot by slot (a strided band among them), forward_hidden
in both schedules against the reference's sequential executor (3
segments), the diagonal executor against the sequential one (9 segments:
its strided bands at G = 2),
``boundary_states_from_capture`` against the reference's gather, the
pipeline and the pooled step, decode and the flush in both serve modes
(the memory tokens through the Mamba layers), and serving: blocking
against interleaved admission, a prefix-cache hit against the cold run.

The reference's weights are drawn once, at two superblocks (16 layers),
and go through ``convert.py``; a test that needs one superblock takes each
position's first layer, and the decode tests a cut of the pattern to its
first three positions (one layer of each block type), where the
reference's compile time is a third of the whole pattern's. Inputs come
from a numpy seed."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import diagonal as jdiag  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.core import diagonal as tdiag  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core.sequential import layer_slice, run_sequential  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.grouped_blocks import make_grouped_apply  # noqa: E402
from repro_torch.serve import PrefixCache, Request, ServeEngine  # noqa: E402

ARCH = "jamba-1.5-large-398b"
# fp32 against fp32: one block or cell is summation order only (1e-5); a
# model over several segments is held at the MoE configs' tolerance
# (tests/test_torch_moe.py): the ARMT recurrence amplifies those
# differences segment by segment, z fastest
ATOL_ONE = 1e-5
ATOL, RTOL, RTOL_Z = 1e-4, 1e-3, 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU ops: the suite runs in
    parallel workers, and the default pool of every worker oversubscribes
    the machine's cores. The count before is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_BASE = {}


def _model(n_super=2, positions=None, **moe_kw):
    """(jax cfg, port cfg, jax params, port params) of the smoke config at
    n_super superblocks of the pattern positions ``positions`` (default
    all 8), MoE fields moe_kw replaced. The weights are drawn once, at 2
    superblocks of the whole pattern; fewer take each position's first
    layers, a cut pattern its positions' trees."""
    if not _BASE:
        jc = dataclasses.replace(j_smoke(ARCH), n_layers=16)
        jp = jax.jit(lambda key: jmodel.init_params(jc, key))(jax.random.PRNGKey(0))
        _BASE["p"] = (jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    jc, tc = j_smoke(ARCH), t_smoke(ARCH)
    positions = tuple(range(len(tc.block_pattern))) if positions is None else positions
    pattern = tuple(tc.block_pattern[p] for p in positions)
    kw = dict(n_layers=n_super * len(pattern), block_pattern=pattern)
    jc, tc = dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)
    if moe_kw:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe_kw))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe_kw))
    jp, tp = _BASE["p"]

    def cut(tree, mp):
        return dict(tree, pattern=tuple(mp(lambda a: a[:n_super], tree["pattern"][p])
                                        for p in positions))
    return (jc, tc, cut(jp, jax.tree_util.tree_map),
            cut(tp, jax.tree_util.tree_map))


def _rows(cfg):
    return cfg.armt.segment_len + cfg.armt.num_mem_tokens


def _close(want, got, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().cpu().float().numpy(), atol=atol, rtol=rtol)


def _bits(a, b):
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def _tokens(seed, B, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, n))


def _state_close(want_tree, got_tree):
    """Every leaf of two executor states ({prelude, pattern}); the memory's
    A and z, which grow to ~190 and ~30 in 3 segments, at RTOL_Z and an
    atol of ATOL times their largest entry (their entries near zero carry
    the others' absolute error)."""
    for part in ("prelude", "pattern"):
        assert len(want_tree[part]) == len(got_tree[part])
        for w, g in zip(want_tree[part], got_tree[part]):
            assert set(w) == set(g)
            for k in w:
                if k in ("A", "z"):
                    _close(w[k], g[k], ATOL * max(1.0, float(w[k].abs().max())), RTOL_Z)
                else:
                    _close(w[k], g[k])


def _state_bits(a_tree, b_tree):
    for part in ("prelude", "pattern"):
        for a, b in zip(a_tree[part], b_tree[part]):
            for k in a:
                _bits(a[k], b[k])


# ---------------------------------------------------------------- config, params
def test_config_and_param_tree_match_reference():
    """get_config and get_smoke_config equal the reference's in every field
    the port carries; init_params has the reference's leaves and shapes
    (a mamba layer's mixer, ln2 and dense FFN; a mamba_moe layer's mixer
    and MoE); validate() refuses a hybrid stack without ARMT or SSM, and a
    pattern of several positions after prelude layers, which the diagonal
    executor refuses too."""
    for mine, theirs in ((t_config(ARCH), j_config(ARCH)), (t_smoke(ARCH), j_smoke(ARCH))):
        m, t = dataclasses.asdict(mine), dataclasses.asdict(theirs)
        assert {k: v for k, v in t.items() if k in m} == m
        assert not mine.use_rope and mine.block_pattern == theirs.block_pattern
    jc, tc, jp, tp = _model()
    mine = tmodel.init_params(tc, 0, device="cpu")
    assert (jax.tree_util.tree_map(lambda t: tuple(t.shape), mine)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), jp))
    assert set(mine["pattern"][2]) == {"ln1", "mixer", "ln2", "ffn"}
    assert set(mine["pattern"][1]) == {"ln1", "mixer", "ln2", "moe"}
    assert mine["pattern"][1]["moe"]["router"].dtype == torch.float32
    for bad in (dict(armt=None), dict(ssm=None), dict(prelude=("attn",), n_layers=17)):
        with pytest.raises(ValueError):
            dataclasses.replace(t_config(ARCH), **bad).validate()
    layout = tsched.StackLayout(prelude=("attn",), pattern=("attn", "mamba"), n_super=1)
    with pytest.raises(ValueError, match="one pattern position"):
        tdiag.pipeline_init(layout, {"prelude": ({},), "pattern": ({}, {})},
                            torch.zeros(1, 1, 4, 8))
    assert list(tsched.StackLayout.from_config(tc).position_slots(3)) == list(
        jsched.StackLayout.from_config(jc).position_slots(3)) == [3, 11]


# ---------------------------------------------------------------- blocks and cells
def _ssm_state(rng, lead, cfg):
    dI = cfg.ssm.expand * cfg.d_model
    return {"h": (rng.standard_normal(lead + (dI, cfg.ssm.d_state)) * 0.1).astype(np.float32),
            "conv": rng.standard_normal(lead + (cfg.ssm.d_conv - 1, dI)).astype(np.float32)}


def _block_state(rng, t, lead, cfg):
    if t == "attn":
        P = 6 * cfg.armt.d_mem
        return {"A": (rng.standard_normal(lead + (P, cfg.d_model)) * 0.1).astype(np.float32),
                "z": rng.uniform(size=lead + (P,)).astype(np.float32)}
    return _ssm_state(rng, lead, cfg)


@pytest.mark.parametrize("t,cb", [("attn", 0), ("mamba", 0), ("mamba", 5), ("mamba", 8),
                                  ("mamba_moe", 0), ("mamba_moe", 5)])
def test_blocks_match_reference(t, cb):
    """The plain blocks against the reference's apply_block at cell_block
    cb (5 divides the 20 rows, 8 does not): attn without rotary, mamba
    with its dense FFN (blockwise at cb), mamba_moe (never blockwise)."""
    jc, tc, jp, tp = _model(n_super=1)
    jc, tc = (dataclasses.replace(c, cell_block=cb) for c in (jc, tc))
    p = tc.block_pattern.index(t)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, _rows(tc), tc.d_model)).astype(np.float32)
    st = _block_state(rng, t, (2,), tc)
    jy, js = jax.jit(lambda pp, xx, ss: jblocks.make_apply_block(jc)(t, pp, xx, ss))(
        jax.tree_util.tree_map(lambda a: a[0], jp["pattern"][p]), jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in st.items()})
    ty, ts = tblocks.make_apply_block(tc)(
        t, layer_slice(tp["pattern"][p], 0), torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in st.items()})
    _close(jy, ty, ATOL_ONE, 0)
    for k in st:
        _close(js[k], ts[k], ATOL_ONE, 1e-5)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("t", ["attn", "mamba", "mamba_moe"])
def test_fused_cells_match_plain_per_slot(t, B):
    """Each fused cell over a band of both superblocks' layers, its input a
    strided view of a slot buffer (stride 8 on the group axis, as the
    diagonal executor's), against the plain block slot by slot; the same
    cell on a contiguous copy of the band gives the same bits."""
    jc, tc, jp, tp = _model(capacity_factor=8.0)
    p = tc.block_pattern.index(t)
    rng = np.random.default_rng(4 + B)
    n = len(tc.block_pattern)
    buf = torch.from_numpy(rng.standard_normal((tc.n_layers, B, _rows(tc), tc.d_model))
                           .astype(np.float32))
    x = buf[p::n]
    assert x.shape[0] == 2 and not x.is_contiguous()
    st = {k: torch.from_numpy(v) for k, v in _block_state(rng, t, (2, B), tc).items()}
    cell = make_grouped_apply(tc)
    got, gst = cell(t, tp["pattern"][p], x, st)
    want, wst = tdiag._per_slot_apply(tblocks.make_apply_block(tc))(
        t, tp["pattern"][p], x, st)
    torch.testing.assert_close(got, want, atol=ATOL_ONE, rtol=0)
    for k in st:
        torch.testing.assert_close(gst[k], wst[k], atol=ATOL_ONE, rtol=1e-5)
    again, ast = cell(t, tp["pattern"][p], x.contiguous(), st)
    _bits(again, got)
    for k in st:
        _bits(ast[k], gst[k])


# ---------------------------------------------------------------- executors
S_FULL = 9      # 9 segments reach a band of 9 slots: every position's cell at G = 2
# random-weight ARMT is chaotic: a last-bit difference grows ~10x a segment
# (by segment 9 any two summation orders disagree in the leading digit), so
# paths that may round differently are compared over their first 3 segments
S_HELD = 3

_REF = {}


def _reference_forward(B):
    """The reference's sequential forward over 3 segments at B rows (hidden,
    final state), once per B."""
    if B not in _REF:
        jc, tc, jp, tp = _model()
        toks = _tokens(13, B, S_HELD * tc.armt.segment_len, tc.vocab)
        jh, jf = jax.jit(lambda p, t: jmodel.forward_hidden(p, jc, t, schedule="sequential"))(
            jp, jnp.asarray(toks))
        _REF[B] = toks, np.asarray(jh), jax.tree_util.tree_map(np.asarray, jf)
    return _REF[B]


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("schedule", ["diagonal", "sequential"])
def test_forward_hidden_matches_reference(schedule, B):
    """forward_hidden on the fused cells over 3 segments against the
    reference's sequential executor: hidden states, every position's final
    state and the last logits."""
    toks, jh, jf = _reference_forward(B)
    jc, tc, jp, tp = _model()
    th, tf = tmodel.forward_hidden(tp, tc, torch.from_numpy(toks), schedule=schedule)
    assert th.shape == jh.shape
    _close(jh, th)
    _state_close(state_from_jax(jf, "cpu"), tf)
    _close(jmodel.last_logits(jp, jc, jnp.asarray(jh)), tmodel.last_logits(tp, tc, th))


@pytest.mark.parametrize("B", [1, 2])
def test_diagonal_equals_sequential_and_captures(B):
    """run_diagonal over the strided bands against run_sequential at 9
    segments: the plain blocks to the bit (hidden states, every layer's
    final state, and the boundary states gathered from the diagonal
    capture against the sequential capture); the fused cells' first 3
    segments (segment 0 passes layers 8-15 in bands of 2 per position)
    within fp32 tolerance of the fused sequential run and of the plain one
    (a band of 2 layers rounds like one on the card, not always on the
    CPU); the gather against the
    reference's ``boundary_states_from_capture`` on the same capture, to
    the bit."""
    jc, tc, jp, tp = _model()
    layout = tsched.StackLayout.from_config(tc)
    ex = {"prelude": tp["prelude"], "pattern": tp["pattern"]}
    apply = tblocks.make_apply_block(tc)
    st0 = tmodel.init_state(tc, B, "cpu", torch.float32)
    segs = torch.from_numpy(np.random.default_rng(B).standard_normal(
        (S_FULL, B, _rows(tc), tc.d_model)).astype(np.float32))
    ys_d, fin_d, cap = tdiag.run_diagonal(layout, ex, st0, segs, apply, capture_states=True)
    ys_s, fin_s, cap_s = run_sequential(layout, ex, st0, segs, apply, capture_states=True)
    _bits(ys_d, ys_s)
    _state_bits(fin_d, fin_s)
    bounds = tdiag.boundary_states_from_capture(layout, cap, S_FULL)
    _state_bits(bounds, cap_s)
    if B == 2:
        jl = jsched.StackLayout.from_config(jc)
        want = jax.jit(lambda c: jdiag.boundary_states_from_capture(jl, c, S_FULL))(
            jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), cap))
        for w, g in zip(want["pattern"], bounds["pattern"]):
            for k in w:
                np.testing.assert_array_equal(np.asarray(w[k]), g[k].numpy())
    cell = make_grouped_apply(tc)
    ys_f, _ = tdiag.run_diagonal(layout, ex, st0, segs, apply, grouped_apply=cell)
    ys_fs, _ = run_sequential(layout, ex, st0, segs, tdiag.one_layer_cell(cell))
    torch.testing.assert_close(ys_f[:S_HELD], ys_fs[:S_HELD], atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(ys_f[:S_HELD], ys_s[:S_HELD], atol=ATOL, rtol=RTOL)


def test_pipeline_and_pooled_step_equal_run_diagonal():
    """The resumable pipeline on the fused cells at budgets of 1 and 3
    steps, with an overshoot, equals run_diagonal to the bit (capture
    included). The pooled step over members of 3 and 9 segments at
    different cursors (the attn position pooled with a layer index, the
    mamba positions member by member) against each member's own run,
    within fp32 tolerance over the first 3 segments and the 3-segment
    member's final state (a pooled band is wider; the card's kernels hold
    it to the bit)."""
    jc, tc, jp, tp = _model()
    layout = tsched.StackLayout.from_config(tc)
    apply, cell = tblocks.make_apply_block(tc), make_grouped_apply(tc)
    st0 = tmodel.init_state(tc, 1, "cpu", torch.float32)
    ex = {"prelude": tp["prelude"], "pattern": tp["pattern"]}
    segs = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (S_FULL, 1, _rows(tc), tc.d_model)).astype(np.float32))
    ys, fin, cap = tdiag.run_diagonal(layout, ex, st0, segs, apply, grouped_apply=cell,
                                      capture_states=True)
    bounds = tdiag.boundary_states_from_capture(layout, cap, S_FULL)
    n = tdiag.n_diagonal_groups(S_FULL, layout.n_layers)
    for k in (1, 3):
        xs, carry = tdiag.pipeline_init(layout, st0, segs, capture_states=True)
        for _ in range(-(-n // k) + 1):
            tdiag.pipeline_step(layout, ex, xs, carry, apply, n_groups=k, grouped_apply=cell)
        out, pfin, pcap = tdiag.pipeline_finalize(layout, carry)
        _bits(out, ys)
        _state_bits(pfin, fin)
        _state_bits(pcap, bounds)
    members = [segs[:3], segs]
    carries = [tdiag.pipeline_init(layout, st0, m)[1] for m in members]
    tdiag.pipeline_step(layout, ex, members[1], carries[1], apply, n_groups=5,
                        grouped_apply=cell)
    tdiag.pool_counts.update(steps=0, member_steps=0)
    for _ in range(n):
        tdiag.pipeline_step_pool(layout, ex, members, carries, apply, grouped_apply=cell)
    assert tdiag.pool_counts["steps"] >= 3
    # each member against its own run_diagonal (the whole one's is ys, fin above)
    for m, carry in zip(members[::-1], carries[::-1]):
        want_ys, want_fin = ((ys, fin) if m is segs else
                             tdiag.run_diagonal(layout, ex, st0, m, apply, grouped_apply=cell))
        out, pfin, _ = tdiag.pipeline_finalize(layout, carry)
        torch.testing.assert_close(out[:S_HELD], want_ys[:S_HELD], atol=ATOL, rtol=RTOL)
    for a, b in zip(pfin["pattern"], want_fin["pattern"]):     # the 3-segment member
        for key in a:
            torch.testing.assert_close(a[key], b[key], atol=ATOL, rtol=RTOL_Z)


# ---------------------------------------------------------------- decode
@pytest.mark.parametrize("serve_mode", ["armt", "cache"])
def test_decode_and_flush_match_reference(serve_mode):
    """decode_step over a 5-token chunk and 2 tokens at a dropless capacity
    (as tests/test_decode.py), in ARMT mode from seeded memory then across
    a flush and one more token; in cache mode into a 32-row cache: logits
    and every state leaf against the reference, on the pattern's first
    three positions (attn, mamba_moe, mamba). The flush runs the memory
    tokens through the Mamba layers: their h moves, as the reference's."""
    jc, tc, jp, tp = _model(n_super=1, positions=(0, 1, 2), capacity_factor=8.0)
    B = 2
    js = jmodel.decode_state_init(jc, B, serve_mode=serve_mode, max_len=32, dtype=jnp.float32)
    if serve_mode == "armt":
        rng = np.random.default_rng(9)
        pat = list(js["pattern"])
        A = pat[0]["A"]
        pat[0] = {**pat[0], "A": jnp.asarray(rng.standard_normal(A.shape).astype(np.float32)
                                             * 0.1),
                  "z": jnp.asarray(rng.uniform(size=pat[0]["z"].shape).astype(np.float32))}
        js = {**js, "pattern": tuple(pat)}
    ts = state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    toks = _tokens(17, B, 9, jc.vocab)
    feeds = [toks[:, :5], toks[:, 5], toks[:, 6]]
    for i, feed in enumerate(feeds + ([None, toks[:, 7]] if serve_mode == "armt" else [])):
        if feed is None:
            h_before = ts["pattern"][2]["h"].clone()
            js = jmodel.flush_segment(jp, jc, js)
            ts = tmodel.flush_segment(tp, tc, ts)
            assert float((ts["pattern"][2]["h"] - h_before).abs().max()) > 1e-3
            assert ts["pos"] == 0 and float(ts["pattern"][0]["k"].abs().max()) == 0
            continue
        jl, js = jmodel.decode_step(jp, jc, js, jnp.asarray(feed), serve_mode=serve_mode)
        tl, ts = tmodel.decode_step(tp, tc, ts, torch.from_numpy(feed), serve_mode=serve_mode)
        _close(jl, tl)
    want = state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    _state_close(want, ts)
    assert ts["pos"] == want["pos"]


# ---------------------------------------------------------------- serving
def test_serving_blocking_interleaved_prefix_cache_and_modes():
    """One superblock served on 2 slots: blocking admission and interleaved
    at k = 1 and 4 give every request the same tokens, each request's first
    token that of a B = 1 generate; a prefix-cache hit on the prompt's 2
    segments gives the cold run's tokens and logits to the bit, its
    generate crossing a flush; cache-mode generate is finite."""
    jc, tc, jp, tp = _model(n_super=1, capacity_factor=8.0)
    seg = tc.armt.segment_len
    eng = ServeEngine(tp, tc, device="cpu", max_len=256)
    rng = np.random.default_rng(21)
    reqs = [(i, rng.integers(0, tc.vocab, n), m)
            for i, (n, m) in enumerate([(2 * seg + 3, 6), (3 * seg, 5), (seg - 2, 7)])]

    def tokens(**kw):
        out = {}
        for e in eng.serve([Request(i, p, m) for i, p, m in reqs], n_slots=2, **kw):
            out.setdefault(e.req_id, []).append(int(e.token))
        return out
    blocking = tokens(prefill_groups_per_chunk=0)
    assert {i: len(t) for i, t in blocking.items()} == {i: m for i, _, m in reqs}
    assert tokens(prefill_groups_per_chunk=1) == blocking
    assert tokens(prefill_groups_per_chunk=4) == blocking
    for i, p, _ in reqs:
        assert eng.generate(p[None], 1).tokens[0, 0] == blocking[i][0]

    cache = PrefixCache(seg)
    ceng = ServeEngine(tp, tc, device="cpu", max_len=256, prefix_cache=cache)
    prompt = np.random.default_rng(23).integers(0, tc.vocab, 2 * seg + 3)
    cold = ceng.generate(prompt[None], seg, keep=True)       # crosses a flush
    hit = ceng.generate(prompt[None], seg, keep=True)
    assert (cold.cached_segments, hit.cached_segments) == (0, 2)
    np.testing.assert_array_equal(hit.tokens, cold.tokens)
    _bits(hit.logits, cold.logits)
    n, snap = cache.match(prompt)
    assert n == 2 and set(snap.state["pattern"][1]) == {"h", "conv"}
    full = ServeEngine(tp, tc, device="cpu", serve_mode="cache", max_len=64)
    fres = full.generate(prompt[None], 4)
    assert cold.finite and fres.finite and fres.tokens.shape == (1, 4)
