"""The MoE ARMT configs (qwen2-moe-a2.7b; kimi-k2-1t-a32b with its dense
prelude layer) against the JAX reference at smoke size (fp32, CPU): the
configs and parameter tree (the router fp32 through the conversion), the
MoE FFN at both dispatches and three capacities (the capacity edge
included: an overflowing expert keeps C - 1 tokens, as the reference's
duplicate-index scatter leaves it), the attn_moe block, the fused attn_moe
cell against the plain block slot by slot (with a layer index, and per-row
dispatch), the diagonal executor, the pipeline and the pooled step with a
prelude against the sequential executor, forward_hidden against the
reference's full-width diagonal executor, decode in both serve modes, and serve's
blocking and interleaved admission.

Inputs come from a numpy seed; the reference's weights go through
``convert.py``. The reference's QKV biases are set to seeded non-zero values
before conversion, so that a dropped bias shows."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import MoEConfig as JMoE  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import sequential as jseq  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import MoEConfig as TMoE  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.core import diagonal as tdiag  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core.sequential import layer_slice, run_sequential  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.grouped_blocks import make_grouped_apply  # noqa: E402
from repro_torch.serve import PrefixCache, Request, ServeEngine, SessionStore  # noqa: E402

ARCHS = ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"]
# fp32 against fp32: one MoE call is summation order only; a model, whose
# ARMT recurrence amplifies those differences segment by segment, is held
# at the dense configs' tolerance for <= 3 segments (z, which grows
# fastest, at rtol 2e-3, as tests/test_torch_dense_configs.py)
MOE_ATOL = 1e-5
ATOL, RTOL, RTOL_Z = 1e-4, 1e-3, 2e-3


def _close(want, got, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().cpu().float().numpy(), atol=atol, rtol=rtol)


def _bits(a, b):
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def _moe(cfg, **kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


_BASE = {}
MAX_LAYERS = {"qwen2-moe-a2.7b": 2, "kimi-k2-1t-a32b": 4}


def _model(arch, n_layers=None, **moe_kw):
    """(jax cfg, port cfg, jax params, port params) of the smoke config at
    n_layers (default the smoke depth) with the MoE fields moe_kw replaced,
    the reference's QKV biases seeded non-zero (qwen). The weights are drawn
    once per arch, at MAX_LAYERS, and a shallower model takes the first
    pattern layers (the MoE fields change no weight)."""
    if arch not in _BASE:
        jc = dataclasses.replace(j_smoke(arch), n_layers=MAX_LAYERS[arch])
        jp = jax.jit(lambda key: jmodel.init_params(jc, key))(jax.random.PRNGKey(0))
        rng = np.random.default_rng(7)
        attn = dict(jp["pattern"][0]["attn"])
        for b in ("bq", "bk", "bv"):
            if b in attn:
                attn[b] = jnp.asarray(rng.standard_normal(attn[b].shape).astype(np.float32)
                                      * 0.1)
        jp = {**jp, "pattern": ({**jp["pattern"][0], "attn": attn},)}
        _BASE[arch] = (jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    jc, tc = j_smoke(arch), t_smoke(arch)
    if n_layers is not None:
        jc = dataclasses.replace(jc, n_layers=n_layers)
        tc = dataclasses.replace(tc, n_layers=n_layers)
    if moe_kw:
        jc, tc = _moe(jc, **moe_kw), _moe(tc, **moe_kw)
    n = tc.n_superblocks
    jp, tp = _BASE[arch]
    jp = {**jp, "pattern": (jax.tree_util.tree_map(lambda a: a[:n], jp["pattern"][0]),)}
    tp = {**tp, "pattern": (jax.tree_util.tree_map(lambda a: a[:n], tp["pattern"][0]),)}
    return jc, tc, jp, tp


_REF = {}


def _ref(key, fn):
    """A reference result computed once per module."""
    if key not in _REF:
        _REF[key] = fn()
    return _REF[key]


def _tokens(seed, B, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, n))


def _memory(rng, lead, P, D):
    return {"A": (rng.standard_normal(lead + (P, D)) * 0.1).astype(np.float32),
            "z": rng.uniform(size=lead + (P,)).astype(np.float32)}


def _rows(cfg):
    return cfg.armt.segment_len + cfg.armt.num_mem_tokens


@pytest.fixture(params=ARCHS)
def arch(request):
    return request.param


# ---------------------------------------------------------------- configs, params
def test_configs_match_reference(arch):
    """get_config and get_smoke_config equal the reference's in every field
    the port carries, the MoE config whole (dispatch included) and the
    prelude's FFN width. validate() refuses the dispatch the port lacks
    and a router dtype other than fp32 (the router is always fp32)."""
    for mine, theirs in ((t_config(arch), j_config(arch)), (t_smoke(arch), j_smoke(arch))):
        m, t = dataclasses.asdict(mine), dataclasses.asdict(theirs)
        assert {k: v for k, v in t.items() if k in m} == m
        assert m["moe"] == t["moe"] and m["prelude_d_ff"] == t["prelude_d_ff"]
    with pytest.raises(ValueError, match="dispatch"):
        _moe(t_config(arch), dispatch="einsum").validate()
    with pytest.raises(ValueError, match="router_dtype"):
        _moe(t_config(arch), router_dtype="bfloat16").validate()


def test_param_tree_matches_reference_with_an_fp32_router(arch):
    """init_params has the reference's leaves and shapes (the prelude's
    per-layer trees, the stacked experts, the fp32 router); the conversion
    keeps the router fp32 when the rest is cast to bf16."""
    jc, tc, jp, tp = _model(arch)
    mine = tmodel.init_params(tc, 0, device="cpu")
    assert (jax.tree_util.tree_map(lambda t: tuple(t.shape), mine)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), jp))
    assert len(mine["prelude"]) == len(jc.prelude)
    bf = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu", torch.bfloat16)
    big = dataclasses.replace(t_config(arch), dtype="bfloat16")
    assert big.moe.router_dtype == "float32"
    assert bf["pattern"][0]["moe"]["router"].dtype == torch.float32
    assert bf["pattern"][0]["moe"]["wg"].dtype == torch.bfloat16
    assert tmodel.init_params(tc, 0, device="cpu")["pattern"][0]["moe"]["router"].dtype \
        == torch.float32


# ---------------------------------------------------------------- the MoE FFN
def _moe_pair(cf, dispatch, seed=0, E=4, K=2, D=32, shared=32):
    jm = JMoE(n_experts=E, top_k=K, d_expert=32, d_shared=shared, capacity_factor=cf,
              dispatch=dispatch)
    tm = TMoE(**dataclasses.asdict(jm))
    jp = jmoe.moe_param_init(jax.random.PRNGKey(seed), D, jm, "silu", jnp.float32)
    return jm, tm, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("dispatch", ["global", "per_row"])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
def test_moe_ffn_matches_reference(cf, dispatch):
    """moe_ffn at a dropless capacity (8.0), the smoke default (1.25) and one
    sure to overflow (0.25), global and per-row dispatch, B = 3 rows of 20
    tokens: within 1e-5 of the reference."""
    jm, tm, jp, tp = _moe_pair(cf, dispatch)
    x = np.random.default_rng(1).standard_normal((3, 20, 32)).astype(np.float32)
    want = jmoe.moe_ffn(jnp.asarray(x), jp, jm, "silu")
    _close(want, tmoe.moe_ffn(torch.from_numpy(x), tp, tm), atol=MOE_ATOL, rtol=0)


def test_overflowing_expert_keeps_c_minus_1_tokens_as_the_reference():
    """E = 2, top-1, C = 8 over 64 tokens, no shared expert: a token the
    MoE drops has an output of exactly zero. In the reference each
    overflowing expert keeps C - 1 = 7 tokens (its rank-(C-1) token is
    dropped by the duplicate-index scatter); the port keeps the same tokens
    and gives the same outputs."""
    jm, tm, jp, tp = _moe_pair(0.25, "global", seed=3, E=2, K=1, shared=0)
    x = np.random.default_rng(2).standard_normal((1, 64, 32)).astype(np.float32)
    C = tmoe.capacity(64, tm)
    assert C == jmoe.capacity(64, jm) == 8
    want = np.asarray(jmoe.moe_ffn(jnp.asarray(x), jp, jm, "silu"))[0]
    got = tmoe.moe_ffn(torch.from_numpy(x), tp, tm)[0].numpy()
    r = tmoe.route(torch.from_numpy(x), tp["router"][None], tm, C)
    eidx, keep = r.eidx[0, :, 0].numpy(), r.keep[0, :, 0].numpy()
    overflowing = 0
    for e in range(2):
        mine = np.flatnonzero(eidx == e)
        if len(mine) <= C:
            continue
        overflowing += 1
        survivors = np.flatnonzero(np.abs(want[mine]).max(-1) > 0)
        np.testing.assert_array_equal(survivors, np.arange(C - 1))   # the first C - 1
        np.testing.assert_array_equal(np.flatnonzero(keep[mine]), np.arange(C - 1))
    assert overflowing >= 1
    np.testing.assert_allclose(want, got, atol=MOE_ATOL, rtol=0)
    np.testing.assert_array_equal(np.abs(want).max(-1) > 0, np.abs(got).max(-1) > 0)


def test_einsum_dispatch_is_refused():
    _, tm, _, tp = _moe_pair(1.25, "global")
    with pytest.raises(ValueError, match="einsum"):
        tmoe.moe_ffn(torch.zeros(1, 4, 32), tp, dataclasses.replace(tm, dispatch="einsum"))


# ---------------------------------------------------------------- block and cell
def test_attn_moe_block_matches_reference(arch):
    jc, tc, jp, tp = _model(arch)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, _rows(jc), jc.d_model)).astype(np.float32)
    st = _memory(rng, (2,), 6 * jc.armt.d_mem, jc.d_model)
    jy, js = jax.jit(lambda p, x_, s_: jblocks.make_apply_block(jc)("attn_moe", p, x_, s_))(
        jax.tree_util.tree_map(lambda a: a[1], jp["pattern"][0]), jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in st.items()})
    ty, ts = tblocks.make_apply_block(tc)(
        "attn_moe", layer_slice(tp["pattern"][0], 1), torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in st.items()})
    _close(jy, ty)
    _close(js["A"], ts["A"])
    _close(js["z"], ts["z"], rtol=RTOL_Z)


@pytest.mark.parametrize("dispatch,B", [("global", 1), ("global", 2), ("per_row", 2)])
def test_fused_moe_cell_matches_plain_block_per_slot(dispatch, B):
    """The fused attn_moe cell (CPU: the kernels' plain versions) over a
    band of both layers against the plain block slot by slot (itself held
    against the reference's above); at B = 2 per-row dispatch too."""
    jc, tc, jp, tp = _model("qwen2-moe-a2.7b", dispatch=dispatch)
    rng = np.random.default_rng(4 + B)
    G = tc.n_layers
    x = rng.standard_normal((G, B, _rows(tc), tc.d_model)).astype(np.float32)
    st = _memory(rng, (G, B), 6 * tc.armt.d_mem, tc.d_model)
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    got, gst = make_grouped_apply(tc)("attn_moe", tp["pattern"][0], torch.from_numpy(x), tst)
    want, wst = tdiag._per_slot_apply(tblocks.make_apply_block(tc))(
        "attn_moe", tp["pattern"][0], torch.from_numpy(x), tst)
    torch.testing.assert_close(got, want, atol=MOE_ATOL, rtol=0)
    torch.testing.assert_close(gst["A"], wst["A"], atol=MOE_ATOL, rtol=1e-5)
    torch.testing.assert_close(gst["z"], wst["z"], atol=MOE_ATOL, rtol=1e-5)


@pytest.mark.parametrize("dispatch", ["global", "per_row"])
def test_fused_moe_cell_with_layer_index_equals_the_gathered_band(dispatch):
    """With a layer index the cell reads the experts as ``widx * E + e`` of
    the flattened stack, the router and memory weights gathered: the stack
    indexed [1, 0, 1] equals the band gathered in that order, to the bit."""
    jc, tc, jp, tp = _model("qwen2-moe-a2.7b", dispatch=dispatch)
    rng = np.random.default_rng(5)
    order = torch.tensor([1, 0, 1])
    x = torch.from_numpy(rng.standard_normal((3, 2, _rows(tc), tc.d_model))
                         .astype(np.float32))
    st = {k: torch.from_numpy(v) for k, v in
          _memory(rng, (3, 2), 6 * tc.armt.d_mem, tc.d_model).items()}
    band = jax.tree_util.tree_map(lambda t: t.index_select(0, order), tp["pattern"][0])
    cell = make_grouped_apply(tc)
    want, wst = cell("attn_moe", band, x, st)
    got, gst = cell("attn_moe", tp["pattern"][0], x, st, order.to(torch.int32))
    _bits(got, want)
    _bits(gst["A"], wst["A"])
    _bits(gst["z"], wst["z"])


# ---------------------------------------------------------------- executors
# (S, n_super) of tests/test_executors.py's one-position layouts, each after
# kimi's one prelude layer, and one with S > L
LAYOUTS = [(1, 1), (2, 3), (3, 2), (3, 1)]


def _segments(tc, S, B=1, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (S, B, _rows(tc), tc.d_model)).astype(np.float32)


@pytest.mark.parametrize("S,n_super", LAYOUTS)
def test_diagonal_with_a_prelude_matches_sequential(S, n_super):
    """run_diagonal over kimi's prelude + n_super MoE layers, fused and
    plain, against the port's and the reference's sequential executors;
    the fused diagonal equals the fused sequential run (the cell applied a
    layer at a time) to the bit on the CPU where the bands are one wide."""
    jc, tc, jp, tp = _model("kimi-k2-1t-a32b", n_layers=1 + n_super)
    segs = _segments(tc, S, B=2, seed=S)
    layout = tsched.StackLayout.from_config(tc)
    assert layout.prelude == ("attn",)
    apply = tblocks.make_apply_block(tc)
    st0 = tmodel.init_state(tc, 2, "cpu", torch.float32)
    ex = {"prelude": tp["prelude"], "pattern": tp["pattern"]}
    x = torch.from_numpy(segs)
    ys_p, fin_p = tdiag.run_diagonal(layout, ex, st0, x, apply)
    ys_f, fin_f = tdiag.run_diagonal(layout, ex, st0, x, apply,
                                     grouped_apply=make_grouped_apply(tc))
    ys_s, fin_s = run_sequential(layout, ex, st0, x, apply)
    _bits(ys_p, ys_s)
    for part in ("prelude", "pattern"):
        for a, b in zip(fin_p[part], fin_s[part]):
            _bits(a["A"], b["A"])
    torch.testing.assert_close(ys_f, ys_s, atol=ATOL, rtol=RTOL)
    jl = jsched.StackLayout.from_config(jc)
    jst0 = jmodel.init_state(jc, 2, "segmented", jnp.float32)
    jys, jfin = jax.jit(lambda p, s0, x: jseq.run_sequential(
        jl, {"prelude": p["prelude"], "pattern": p["pattern"]}, s0, x,
        jblocks.make_apply_block(jc)))(jp, jst0, jnp.asarray(segs))
    _close(jys, ys_f)
    _close(jfin["prelude"][0]["z"], fin_f["prelude"][0]["z"], rtol=RTOL_Z)
    _close(jfin["pattern"][0]["A"], fin_f["pattern"][0]["A"])


def test_pipeline_and_pooled_step_with_a_prelude_equal_run_diagonal():
    """The resumable pipeline over kimi's prelude + 3 MoE layers, at
    budgets of 1 and 3 steps with an overshoot, equals run_diagonal to the
    bit (prelude state and capture included). Within fp32 tolerance, since
    a band of another width may round differently on the CPU (the card's
    kernels hold these to the bit): the boundary states gathered from the
    capture against run_diagonal over the first c segments, and the pooled
    step over members of 2 and 5 segments at different cursors against
    each member's own run, its prelude too."""
    jc, tc, jp, tp = _model("kimi-k2-1t-a32b", n_layers=4)
    layout = tsched.StackLayout.from_config(tc)
    apply, cell = tblocks.make_apply_block(tc), make_grouped_apply(tc)
    st0 = tmodel.init_state(tc, 1, "cpu", torch.float32)
    ex = {"prelude": tp["prelude"], "pattern": tp["pattern"]}
    segs = torch.from_numpy(_segments(tc, 5, seed=11))
    ys, fin, cap = tdiag.run_diagonal(layout, ex, st0, segs, apply, grouped_apply=cell,
                                      capture_states=True)
    bounds = tdiag.boundary_states_from_capture(layout, cap, 5)
    for c in (1, 3):
        _, fin_c = tdiag.run_diagonal(layout, ex, st0, segs[:c], apply, grouped_apply=cell)
        for part in ("prelude", "pattern"):
            for k in ("A", "z"):
                torch.testing.assert_close(bounds[part][0][k][c - 1], fin_c[part][0][k],
                                           atol=ATOL, rtol=RTOL_Z)
    for k in (1, 3):
        xs, carry = tdiag.pipeline_init(layout, st0, segs, capture_states=True)
        for _ in range(-(-tdiag.n_diagonal_groups(5, 4) // k) + 1):
            tdiag.pipeline_step(layout, ex, xs, carry, apply, n_groups=k, grouped_apply=cell)
        out, pfin, pcap = tdiag.pipeline_finalize(layout, carry)
        _bits(out, ys)
        _bits(pfin["prelude"][0]["A"], fin["prelude"][0]["A"])
        _bits(pfin["pattern"][0]["A"], fin["pattern"][0]["A"])
        _bits(pcap["prelude"][0]["z"], bounds["prelude"][0]["z"])
        _bits(pcap["pattern"][0]["A"], bounds["pattern"][0]["A"])
    members = [segs[:2], segs]
    carries = [tdiag.pipeline_init(layout, st0, m)[1] for m in members]
    tdiag.pipeline_step(layout, ex, members[1], carries[1], apply, n_groups=2,
                        grouped_apply=cell)
    for _ in range(8):
        tdiag.pipeline_step_pool(layout, ex, members, carries, apply, grouped_apply=cell)
    for m, carry in zip(members, carries):
        want_ys, want_fin = tdiag.run_diagonal(layout, ex, st0, m, apply, grouped_apply=cell)
        out, pfin, _ = tdiag.pipeline_finalize(layout, carry)
        torch.testing.assert_close(out, want_ys, atol=ATOL, rtol=RTOL)
        for part in ("prelude", "pattern"):
            torch.testing.assert_close(pfin[part][0]["A"], want_fin[part][0]["A"], atol=ATOL,
                                       rtol=RTOL)


def test_diagonal_rejects_a_pattern_of_two_positions():
    layout = tsched.StackLayout(prelude=("attn",), pattern=("attn", "attn_moe"), n_super=1)
    with pytest.raises(ValueError, match="one pattern position"):
        tdiag.pipeline_init(layout, {"prelude": ({},), "pattern": ({}, {})},
                            torch.zeros(1, 1, 4, 8))


# ---------------------------------------------------------------- model and serving
@pytest.mark.parametrize("schedule", ["diagonal", "sequential"])
def test_forward_hidden_matches_reference_full_width(arch, schedule):
    """forward_hidden on the fused cell, 3 segments at B = 2, against the
    reference's full-width diagonal executor (grouped_impl='vmap', no band
    skipping); the final state (prelude included) and the last logits."""
    jc, tc, jp, tp = _model(arch)
    toks = _tokens(13, 2, 3 * jc.armt.segment_len, jc.vocab)
    jh, jf = _ref(("forward", arch), lambda: jax.jit(
        lambda p, t: jmodel.forward_hidden(p, jc, t, schedule="diagonal",
                                           grouped_impl="vmap"))(jp, jnp.asarray(toks)))
    th, tf = tmodel.forward_hidden(tp, tc, torch.from_numpy(toks), schedule=schedule)
    assert th.shape == jh.shape
    _close(jh, th)
    for part in ("prelude", "pattern"):
        assert len(tf[part]) == len(jf[part])
        for a, b in zip(jf[part], tf[part]):
            _close(a["z"], b["z"], rtol=RTOL_Z)
    _close(jmodel.last_logits(jp, jc, jh), tmodel.last_logits(tp, tc, th))


@pytest.mark.parametrize("serve_mode", ["armt", "cache"])
def test_decode_steps_match_reference(arch, serve_mode):
    """decode_step over 4 tokens after a 5-token chunk at a dropless
    capacity (8.0, as tests/test_decode.py), in ARMT mode from seeded
    memory and in cache mode: logits and every state leaf, the prelude's
    caches included; then a flush in ARMT mode."""
    jc, tc, jp, tp = _model(arch, capacity_factor=8.0)
    B, max_len = 2, 32
    js = jmodel.decode_state_init(jc, B, serve_mode=serve_mode, max_len=max_len,
                                  dtype=jnp.float32)
    if serve_mode == "armt":
        rng = np.random.default_rng(9)

        def seeded(st):
            mem = _memory(rng, st["A"].shape[:-2], *st["A"].shape[-2:])
            return {**st, **{k: jnp.asarray(v) for k, v in mem.items()}}
        js = {**js, "prelude": tuple(seeded(s) for s in js["prelude"]),
              "pattern": tuple(seeded(s) for s in js["pattern"])}
    ts = state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    toks = _tokens(17, B, 9, jc.vocab)
    step = jax.jit(lambda p, s, t: jmodel.decode_step(p, jc, s, t, serve_mode=serve_mode))
    for feed in [toks[:, :5]] + [toks[:, t] for t in range(5, 9)]:
        jl, js = step(jp, js, jnp.asarray(feed))
        tl, ts = tmodel.decode_step(tp, tc, ts, torch.from_numpy(feed), serve_mode=serve_mode)
        _close(jl, tl)
    if serve_mode == "armt":
        js = jax.jit(lambda p, s: jmodel.flush_segment(p, jc, s))(jp, js)
        ts = tmodel.flush_segment(tp, tc, ts)
    want = state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    for part in ("prelude", "pattern"):
        for w, g in zip(want[part], ts[part]):
            assert w.keys() == g.keys()
            for k in w:
                _close(w[k], g[k], rtol=RTOL_Z)
    assert ts["pos"] == want["pos"]


def test_serve_blocking_equals_interleaved_tokens():
    """kimi's smoke config (prelude + MoE) served on 2 slots: blocking
    admission, interleaved at k = 1 and k = 4 (pooled band steps over the
    prelude and the MoE cells) give every request the same tokens, each
    request's first token that of a B = 1 generate."""
    jc, tc, jp, tp = _model("kimi-k2-1t-a32b", capacity_factor=8.0)
    eng = ServeEngine(tp, tc, device="cpu", max_len=256)
    seg = tc.armt.segment_len
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


def test_prefix_cache_and_session_store_carry_the_prelude():
    """kimi's smoke config with the serving state stores: a prefix-cache hit
    on the prompt's 2 segments gives the cold run's tokens and every
    step's logits to the bit, the snapshot holding the prelude layer's
    memory beside the pattern's; a stored session holds the prelude's
    memory and its KV cache."""
    jc, tc, jp, tp = _model("kimi-k2-1t-a32b", capacity_factor=8.0)
    seg = tc.armt.segment_len
    cache = PrefixCache(seg)
    eng = ServeEngine(tp, tc, device="cpu", max_len=256, prefix_cache=cache,
                      session_store=SessionStore())
    prompt = np.random.default_rng(23).integers(0, tc.vocab, 2 * seg + 3)
    cold = eng.generate(prompt[None], 4, keep=True)
    hit = eng.generate(prompt[None], 4, keep=True)
    assert (cold.cached_segments, hit.cached_segments) == (0, 2)
    np.testing.assert_array_equal(hit.tokens, cold.tokens)
    _bits(hit.logits, cold.logits)
    n, snap = cache.match(prompt)
    assert n == 2
    for part in ("prelude", "pattern"):
        assert len(snap.state[part]) == 1 and float(snap.state[part][0]["z"].abs().sum()) > 0
    eng.generate(prompt[None], 3, session_id="s")
    st = eng.session_store.get("s").state
    assert set(st["prelude"][0]) == {"A", "z", "k", "v"}
    assert float(st["prelude"][0]["k"].abs().sum()) > 0
