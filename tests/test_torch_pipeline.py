"""The port's resumable diagonal pipeline (core/diagonal.py) against the JAX
reference at smoke size (fp32, CPU): the suspended-pipeline cursors, the
per-step state capture and its boundary gather, boundary_logits, the
streamed outputs, pipeline_step at several group budgets and the pooled
step over members at different cursors; and the GEMM's layer index.

The reference is held to the full-width JAX executor (``band_skip=False``)
within fp32 tolerance; bitwise claims are made only inside the port (the
stepper against the one-shot executor, stream against full ys, the layer
index against the gathered weights)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import diagonal as jdiag  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import diagonal as tdiag  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.kernels import grouped_matmul as gmm  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.grouped_blocks import make_grouped_apply  # noqa: E402

ARCH = "llama-1b-armt"
# fp32 both sides; the ARMT recurrence amplifies summation-order
# differences segment by segment, so these hold for <= 4 segments (z, which
# grows fastest, at rtol 2e-3)
ATOL, RTOL, RTOL_Z = 1e-4, 1e-3, 2e-3
# (n_layers, S): S < L and S > L
SHAPES = [(4, 3), (2, 3)]

_CACHE = {}


def _model(n_layers):
    if n_layers not in _CACHE:
        jc = dataclasses.replace(j_smoke(ARCH), n_layers=n_layers)
        tc = dataclasses.replace(t_smoke(ARCH), n_layers=n_layers)
        jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        _CACHE[n_layers] = (jc, tc, jp, tp)
    return _CACHE[n_layers]


def _exec(p):
    return {"prelude": p["prelude"], "pattern": p["pattern"]}


def _segments(tc, S, B=1, seed=0):
    T = tc.armt.segment_len + tc.armt.num_mem_tokens
    return np.random.default_rng(seed).standard_normal((S, B, T, tc.d_model)).astype(np.float32)


def _jax_run(jc, jp, segs, **kw):
    layout = jsched.StackLayout.from_config(jc)
    apply = jblocks.make_apply_block(jc, mode="segmented", ssm_method="assoc")
    st0 = jmodel.init_state(jc, segs.shape[1], "segmented", jnp.float32)
    return jdiag.run_diagonal(layout, _exec(jp), st0, jnp.asarray(segs), apply,
                              band_skip=False, **kw)


def _port(tc, tp, segs):
    layout = tsched.StackLayout.from_config(tc)
    apply = tblocks.make_apply_block(tc, "segmented")
    st0 = tmodel.init_state(tc, segs.shape[1], "cpu", torch.float32)
    return layout, apply, make_grouped_apply(tc), st0, torch.from_numpy(segs)


def _close(want, got, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(want, np.float32), got.detach().float().numpy(),
                               atol=ATOL, rtol=rtol)


def _bits(a, b):
    torch.testing.assert_close(a, b, atol=0, rtol=0)


# ------------------------------------------------------------------ cursors

@pytest.mark.parametrize("S,L", [(5, 3), (3, 5), (4, 4), (1, 6), (7, 1)])
def test_cursors_match_reference(S, L):
    """Every cursor function of a suspended pipeline equals the
    reference's, over the grid and past it (overshoot)."""
    n = tsched.n_diagonal_groups(S, L)
    for i in range(n + 3):
        for fn in ("segments_completed", "segments_entered", "group_size",
                   "cells_completed"):
            assert getattr(tsched, fn)(i, S, L) == getattr(jsched, fn)(i, S, L), (fn, i)
    assert tsched.segments_completed(n, S, L) == S == tsched.segments_entered(n, S, L)
    assert tsched.cells_completed(n + 2, S, L) == S * L


@pytest.mark.parametrize("L", [1, 3, 4])
def test_pool_cells_remaining_matches_reference(L):
    steps, counts = [0, 2, 5, 40], [3, 6, 1, 2]
    for k in range(len(steps) + 1):
        assert (tsched.pool_cells_remaining(steps[:k], counts[:k], L)
                == jsched.pool_cells_remaining(steps[:k], counts[:k], L))
    assert tsched.pool_cells_remaining([0], [6], L) == 6 * L
    with pytest.raises(ValueError):
        tsched.pool_cells_remaining([0, 1], [3], L)


# ------------------------------------------------------------------ capture

@pytest.mark.parametrize("n_layers,S", SHAPES)
def test_capture_and_boundary_states_match_reference(n_layers, S):
    """run_diagonal(capture_states=True): ys, the final state, every step's
    capture and the gathered boundary states against the reference's
    full-width executor; the last boundary is the final state to the bit."""
    jc, tc, jp, tp = _model(n_layers)
    segs = _segments(tc, S, seed=n_layers + S)
    jys, jfin, jcap = _jax_run(jc, jp, segs, capture_states=True)
    jbs = jdiag.boundary_states_from_capture(jsched.StackLayout.from_config(jc), jcap, S)
    layout, apply, gapply, st0, x = _port(tc, tp, segs)
    ys, fin, cap = tdiag.run_diagonal(layout, _exec(tp), st0, x, apply, grouped_apply=gapply,
                                      capture_states=True)
    bs = tdiag.boundary_states_from_capture(layout, cap, S)
    _close(jys, ys)
    for k in ("A", "z"):
        rtol = RTOL_Z if k == "z" else RTOL
        assert cap["pattern"][0][k].shape[0] == S + n_layers - 1
        _close(jcap["pattern"][0][k], cap["pattern"][0][k], rtol)
        assert bs["pattern"][0][k].shape[:2] == (S, n_layers)
        _close(jbs["pattern"][0][k], bs["pattern"][0][k], rtol)
        _bits(bs["pattern"][0][k][-1], fin["pattern"][0][k])


@pytest.mark.parametrize("c", [1, 2, 3])
def test_boundary_state_is_the_state_after_c_segments(c):
    """Boundary c of the capture equals the final state of the port's run
    over the first c segments. The two runs have bands of other widths, and
    the CPU's batched matmul may round a group differently at another batch
    size, so this holds within tolerance here (the card's kernels hold it
    to the bit: chip_smoke.py phase (o))."""
    jc, tc, jp, tp = _model(4)
    segs = _segments(tc, 3, seed=7)
    layout, apply, gapply, st0, x = _port(tc, tp, segs)
    _, _, cap = tdiag.run_diagonal(layout, _exec(tp), st0, x, apply, grouped_apply=gapply,
                                   capture_states=True)
    bs = tdiag.boundary_states_from_capture(layout, cap, 3)
    _, fin = tdiag.run_diagonal(layout, _exec(tp), st0, x[:c], apply, grouped_apply=gapply)
    for k in ("A", "z"):
        torch.testing.assert_close(bs["pattern"][0][k][c - 1], fin["pattern"][0][k],
                                   atol=ATOL, rtol=RTOL_Z)


def test_boundary_logits_match_reference():
    jc, tc, jp, tp = _model(2)
    h = np.random.default_rng(3).standard_normal((3, 2, 5, tc.d_model)).astype(np.float32)
    want = jmodel.boundary_logits(jp, jc, jnp.asarray(h))
    got = tmodel.boundary_logits(tp, tc, torch.from_numpy(h))
    assert got.shape == (3, 2, tc.vocab) and got.dtype == torch.float32
    _close(want, got)
    _bits(got[-1], tmodel.last_logits(tp, tc, torch.from_numpy(h)))


# ------------------------------------------------------------------ streamed outputs

@pytest.mark.parametrize("n_layers,S", SHAPES)
def test_stream_matches_reference_and_full_ys(n_layers, S):
    """run_diagonal(stream_ys=True): win and brow against the reference's
    stream within tolerance, and to the bit against the port's full ys
    (segment s at win[s % W], brow[s] = ys[s, :, retain_pos])."""
    jc, tc, jp, tp = _model(n_layers)
    segs = _segments(tc, S, B=2, seed=11 + S)
    pos = tc.armt.segment_len - 1
    jout, _ = _jax_run(jc, jp, segs, stream_ys=True, retain_pos=pos)
    layout, apply, gapply, st0, x = _port(tc, tp, segs)
    out, fin = tdiag.run_diagonal(layout, _exec(tp), st0, x, apply, grouped_apply=gapply,
                                  stream_ys=True, retain_pos=pos)
    ys, fin_full = tdiag.run_diagonal(layout, _exec(tp), st0, x, apply, grouped_apply=gapply)
    W = min(n_layers, S)
    assert out["win"].shape[0] == W and out["brow"].shape == (S, 2, tc.d_model)
    _close(jout["win"], out["win"])
    _close(jout["brow"], out["brow"])
    _bits(out["brow"], ys[:, :, pos])
    for s in range(S - W, S):
        _bits(out["win"][s % W], ys[s])
    for k in ("A", "z"):
        _bits(fin["pattern"][0][k], fin_full["pattern"][0][k])


# ------------------------------------------------------------------ resumable pipeline

@pytest.mark.parametrize("n_layers,S", SHAPES)
@pytest.mark.parametrize("stream", [False, True])
def test_pipeline_step_bitexact_vs_run_diagonal(n_layers, S, stream):
    """pipeline_init/step/finalize at budgets k = 1, 3, n_steps and n_steps
    + 5 (overshoot: no-op steps) equal the one-shot run_diagonal to the bit
    (outputs, final state, boundary states) and the reference within
    tolerance; the caller's state0 is never written."""
    jc, tc, jp, tp = _model(n_layers)
    segs = _segments(tc, S, seed=21 + S)
    jys, jfin = _jax_run(jc, jp, segs)
    layout, apply, gapply, st0, x = _port(tc, tp, segs)
    ref_out, ref_fin, ref_cap = tdiag.run_diagonal(layout, _exec(tp), st0, x, apply,
                                                   grouped_apply=gapply, capture_states=True,
                                                   stream_ys=stream)
    ref_bs = tdiag.boundary_states_from_capture(layout, ref_cap, S)
    n_steps = tsched.n_diagonal_groups(S, n_layers)
    for k in (1, 3, n_steps, n_steps + 5):
        xs, carry = tdiag.pipeline_init(layout, st0, x, capture_states=True, stream_ys=stream)
        calls = 0
        while calls * k < n_steps:
            assert tsched.segments_completed(carry["step"], S, n_layers) < S
            tdiag.pipeline_step(layout, _exec(tp), xs, carry, apply, n_groups=k,
                                grouped_apply=gapply)
            calls += 1
        assert carry["step"] == calls * k
        out, fin, bs = tdiag.pipeline_finalize(layout, carry)
        for key in (("win", "brow") if stream else (None,)):
            _bits(out[key] if key else out, ref_out[key] if key else ref_out)
        for leaf in ("A", "z"):
            _bits(fin["pattern"][0][leaf], ref_fin["pattern"][0][leaf])
            _bits(bs["pattern"][0][leaf], ref_bs["pattern"][0][leaf])
    if not stream:
        _close(jys, out)
    for leaf in ("A", "z"):
        _close(jfin["pattern"][0][leaf], fin["pattern"][0][leaf],
               RTOL_Z if leaf == "z" else RTOL)
        assert not st0["pattern"][0][leaf].any()


def test_pipeline_finalize_refuses_an_unfinished_carry():
    jc, tc, jp, tp = _model(2)
    layout, apply, gapply, st0, x = _port(tc, tp, _segments(tc, 2))
    xs, carry = tdiag.pipeline_init(layout, st0, x)
    tdiag.pipeline_step(layout, _exec(tp), xs, carry, apply, n_groups=2, grouped_apply=gapply)
    with pytest.raises(ValueError):
        tdiag.pipeline_finalize(layout, carry)


def _pool_members(tc, tp, layout, apply, gapply, specs):
    """Fresh carries of (segments, groups already run) each."""
    members = []
    for i, (S, done) in enumerate(specs):
        segs = torch.from_numpy(_segments(tc, S, seed=40 + i))
        st0 = tmodel.init_state(tc, 1, "cpu", torch.float32)
        xs, carry = tdiag.pipeline_init(layout, st0, segs)
        tdiag.pipeline_step(layout, _exec(tp), xs, carry, apply, n_groups=done,
                            grouped_apply=gapply)
        members.append((xs, carry))
    return members


@pytest.mark.parametrize("k", [1, 3])
def test_pooled_step_matches_each_members_own_step(k):
    """pipeline_step_pool over members at a fresh cursor, mid-grid and past
    the end (2, 4 and 3 segments, 4 layers): each member equals its own
    pipeline_step within tolerance, every cursor moves by k, and a step of
    two or more live members is one cell call with a layer index."""
    jc, tc, jp, tp = _model(4)
    layout = tsched.StackLayout.from_config(tc)
    apply, gapply = tblocks.make_apply_block(tc, "segmented"), make_grouped_apply(tc)
    specs = [(2, 0), (4, 3), (3, 9)]
    pool = _pool_members(tc, tp, layout, apply, gapply, specs)
    own = _pool_members(tc, tp, layout, apply, gapply, specs)
    calls = []

    def counting(t, p, x, state, widx=None):
        calls.append(None if widx is None else widx.tolist())
        return gapply(t, p, x, state, widx=widx)
    counting.indexed = gapply.indexed
    tdiag.pipeline_step_pool(layout, _exec(tp), [m[0] for m in pool], [m[1] for m in pool],
                             apply, n_groups=k, grouped_apply=counting)
    for xs, carry in own:
        tdiag.pipeline_step(layout, _exec(tp), xs, carry, apply, n_groups=k,
                            grouped_apply=gapply)
    assert len(calls) == k and all(c is not None for c in calls)
    # step one: member 0 at band [0, 0], member 1 (cursor 3) at [0, 3]
    assert calls[0] == [0, 0, 1, 2, 3]
    for (_, got), (_, want), (_, done) in zip(pool, own, specs):
        assert got["step"] == want["step"] == done + k
        torch.testing.assert_close(got["buf"], want["buf"], atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(got["ys"], want["ys"], atol=ATOL, rtol=RTOL)
        for leaf in ("A", "z"):
            torch.testing.assert_close(got["state"]["pattern"][0][leaf],
                                       want["state"]["pattern"][0][leaf],
                                       atol=ATOL, rtol=RTOL_Z)


def test_pooled_members_share_no_storage():
    """Every carry of a pool holds its own buffers before and after a
    pooled step (none is a view of another's, or of the state it began
    from)."""
    jc, tc, jp, tp = _model(4)
    layout = tsched.StackLayout.from_config(tc)
    apply, gapply = tblocks.make_apply_block(tc, "segmented"), make_grouped_apply(tc)
    pool = _pool_members(tc, tp, layout, apply, gapply, [(2, 0), (3, 1), (3, 2)])

    def storages(carry):
        leaves = [carry["buf"], carry["ys"], *carry["state"]["pattern"][0].values()]
        return {t.untyped_storage().data_ptr() for t in leaves}
    tdiag.pipeline_step_pool(layout, _exec(tp), [m[0] for m in pool], [m[1] for m in pool],
                             apply, n_groups=2, grouped_apply=gapply)
    sets = [storages(c) for _, c in pool]
    for i in range(len(sets)):
        for j in range(i + 1, len(sets)):
            assert not sets[i] & sets[j], (i, j)
    params = {t.untyped_storage().data_ptr()
              for t in jax.tree_util.tree_leaves(tp) if isinstance(t, torch.Tensor)}
    assert not params & set().union(*sets)


def test_pool_of_a_cell_without_layer_index_steps_members_in_turn():
    """A cell that takes no layer index (the plain per-slot oracle here; the
    mamba cell on the model path) advances the members one after another:
    each equals its own step to the bit."""
    jc, tc, jp, tp = _model(2)
    layout = tsched.StackLayout.from_config(tc)
    apply = tblocks.make_apply_block(tc, "segmented")
    specs = [(2, 0), (3, 2)]
    pool = _pool_members(tc, tp, layout, apply, None, specs)
    own = _pool_members(tc, tp, layout, apply, None, specs)
    tdiag.pipeline_step_pool(layout, _exec(tp), [m[0] for m in pool], [m[1] for m in pool],
                             apply, n_groups=2)
    for (xs, want), (_, got) in zip(own, pool):
        tdiag.pipeline_step(layout, _exec(tp), xs, want, apply, n_groups=2)
        _bits(got["ys"], want["ys"])
        _bits(got["state"]["pattern"][0]["A"], want["state"]["pattern"][0]["A"])


# ------------------------------------------------------------------ layer index

@pytest.mark.parametrize("act", [None, "silu", "gelu"])
def test_grouped_matmul_layer_index_equals_gathered_weights(act):
    """Group i of a launch with a layer index takes w[widx[i]] (and its
    bias) of the whole stack: the plain version equals the call on the
    gathered weights to the bit."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((5, 7, 12)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 12, 9)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 9)).astype(np.float32))
    widx = torch.tensor([2, 0, 0, 1, 2], dtype=torch.int32)
    got = gmm.grouped_matmul(x, w, b, activation=act, widx=widx)
    want = gmm.grouped_matmul(x, w[widx.long()], b[widx.long()], activation=act)
    _bits(got, want)


def test_fused_cell_with_layer_index_equals_the_gathered_band():
    """The attn cell given the whole stack and a layer index equals, to the
    bit on the CPU, the cell given those layers' weights gathered."""
    jc, tc, jp, tp = _model(4)
    gapply = make_grouped_apply(tc)
    assert gapply.indexed == ("attn", "attn_moe", "dec")
    widx = torch.tensor([3, 0, 1, 1], dtype=torch.int32)
    pat = tp["pattern"][0]
    gathered = jax.tree_util.tree_map(lambda a: a[widx.long()], pat)
    x = torch.from_numpy(_segments(tc, 4, seed=9)[:, :1].copy())      # [G, 1, T, D]
    st = tmodel.init_state(tc, 1, "cpu", torch.float32)["pattern"][0]
    st = {k: torch.rand((4,) + v.shape[1:], generator=torch.Generator().manual_seed(2)) + 0.1
          for k, v in st.items()}
    y1, s1 = gapply("attn", pat, x, st, widx=widx)
    y2, s2 = gapply("attn", gathered, x, st)
    _bits(y1, y2)
    for k in ("A", "z"):
        _bits(s1[k], s2[k])
    with pytest.raises(ValueError):
        gapply("mamba", pat, x, st, widx=widx)
