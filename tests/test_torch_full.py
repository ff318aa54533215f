"""The port's full-attention mode (the paper's baseline: one segment of the
whole prompt, no memory tokens, no memory) against the JAX reference at
smoke size (fp32, CPU), for the four Llama ARMT configs and falcon-mamba-7b,
under both executors on the plain block and on the fused cell; the 'auto'
schedule's choice; and the sequential executor on the fused cell (a band of
one layer) against the diagonal one."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.blocks import block_state_init as j_block_state_init  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

ARCHS = ["llama-1b-armt", "llama-160m-armt", "llama-3b-armt", "llama-8b-armt",
         "falcon-mamba-7b"]
# fp32 against fp32, as tests/test_torch_model.py: full mode has no ARMT
# recurrence to amplify summation-order differences
ATOL, RTOL = 1e-4, 1e-3
# prompt length: not a multiple of the smoke configs' 16-token segment
N_TOKENS = 40

_CACHE = {}


def _model(arch, n_layers=None):
    if (arch, n_layers) not in _CACHE:
        jc, tc = j_smoke(arch), t_smoke(arch)
        if n_layers:
            jc = dataclasses.replace(jc, n_layers=n_layers)
            tc = dataclasses.replace(tc, n_layers=n_layers)
        jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        _CACHE[arch, n_layers] = (jc, tc, jp, tp)
    return _CACHE[arch, n_layers]


def _tokens(seed, B, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, n))


_WANT = {}


def _reference_full(arch):
    """JAX's forward_hidden(mode='full') (its sequential executor, the
    reference's oracle) and last_logits, once per arch."""
    if arch not in _WANT:
        jc, _, jp, _ = _model(arch)
        toks = _tokens(3, 2, N_TOKENS, jc.vocab)
        jh, _ = jmodel.forward_hidden(jp, jc, jnp.asarray(toks), schedule="sequential",
                                      mode="full")
        _WANT[arch] = (toks, np.asarray(jh), np.asarray(jmodel.last_logits(jp, jc, jh)))
    return _WANT[arch]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("schedule,fused", [("diagonal", True), ("diagonal", False),
                                            ("sequential", True), ("sequential", False)])
def test_full_mode_matches_reference(arch, schedule, fused):
    _, tc, _, tp = _model(arch)
    toks, want_h, want_logits = _reference_full(arch)
    th, tf = tmodel.forward_hidden(tp, tc, torch.from_numpy(toks), schedule=schedule,
                                   fused=fused, mode="full")
    assert th.shape == want_h.shape == (1, 2, N_TOKENS, tc.d_model)
    np.testing.assert_allclose(want_h, th.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(want_logits, tmodel.last_logits(tp, tc, th).numpy(),
                               atol=ATOL, rtol=RTOL)
    if arch.startswith("llama"):      # no memory: an attn layer carries no state
        assert tf["pattern"][0] == {}


def test_full_mode_matches_reference_diagonal_executor():
    """Against the reference's diagonal executor in full mode too (one
    segment: L band steps of one layer)."""
    jc, tc, jp, tp = _model("llama-1b-armt")
    toks = _tokens(4, 2, N_TOKENS, jc.vocab)
    jh, _ = jmodel.forward_hidden(jp, jc, jnp.asarray(toks), schedule="diagonal",
                                  mode="full", grouped_impl="vmap")
    th, _ = tmodel.forward_hidden(tp, tc, torch.from_numpy(toks), mode="full")
    np.testing.assert_allclose(np.asarray(jh), th.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", ["llama-1b-armt", "falcon-mamba-7b"])
def test_full_mode_state_and_blocks(arch):
    """Full mode's executor state: nothing for an attn layer, a zero SSM
    state for a mamba layer (the reference's block_state_init)."""
    jc, tc, _, _ = _model(arch)
    t = tc.block_pattern[0]
    mine = tblocks.block_state_init(t, tc, 2, "cpu", torch.float32, "full")
    want = j_block_state_init(t, jc, 2, "full", jnp.float32)
    assert set(mine) == set(want)
    for k in mine:
        assert tuple(mine[k].shape) == tuple(want[k].shape)
        assert not mine[k].any()
    state = tmodel.init_state(tc, 2, "cpu", mode="full")
    assert set(state["pattern"][0]) == set(want)
    with pytest.raises(ValueError):
        tmodel.init_state(tc, 2, "cpu", mode="segments")


def test_full_mode_ignores_seg_len_and_memory_tokens():
    """One segment of the whole prompt: a seg_len argument changes nothing,
    and the memory tokens are not appended."""
    _, tc, _, tp = _model("llama-1b-armt")
    toks = torch.from_numpy(_tokens(5, 1, 3 * tc.armt.segment_len, tc.vocab))
    h, _ = tmodel.forward_hidden(tp, tc, toks, mode="full")
    h8, _ = tmodel.forward_hidden(tp, tc, toks, mode="full", seg_len=8)
    assert h.shape == (1, 1, toks.shape[1], tc.d_model)
    torch.testing.assert_close(h8, h, atol=0, rtol=0)
    with pytest.raises(ValueError):
        tmodel.forward_hidden(tp, tc, toks, mode="fulll")


@pytest.mark.parametrize("fused", [True, False])
def test_full_mode_diagonal_equals_sequential_to_the_bit(fused):
    """One segment: the diagonal executor runs L bands of one layer, the
    same cell calls as the sequential executor, so the two agree to the bit
    on the fused cell and on the plain block."""
    _, tc, _, tp = _model("llama-1b-armt")
    toks = torch.from_numpy(_tokens(6, 2, N_TOKENS, tc.vocab))
    d, _ = tmodel.forward_hidden(tp, tc, toks, mode="full", schedule="diagonal", fused=fused)
    s, _ = tmodel.forward_hidden(tp, tc, toks, mode="full", schedule="sequential",
                                 fused=fused)
    torch.testing.assert_close(s, d, atol=0, rtol=0)


# (S segments, L layers) around the S >= L switch; at most 4 segments, as
# the ARMT tolerance is stated for (tests/test_torch_model.py)
@pytest.mark.parametrize("S,L", [(1, 2), (2, 2), (3, 2), (2, 4), (3, 4), (4, 4)])
def test_auto_schedule_chooses_as_reference(monkeypatch, S, L):
    jc, tc, jp, tp = _model("llama-1b-armt", L if L != 2 else None)
    seen = {"jax": [], "torch": []}

    def spy(store, name, fn):
        def wrapped(*a, **k):
            store.append(name)
            return fn(*a, **k)
        return wrapped
    for name in ("run_diagonal", "run_sequential"):
        monkeypatch.setattr(jmodel, name, spy(seen["jax"], name, getattr(jmodel, name)))
        monkeypatch.setattr(tmodel, name, spy(seen["torch"], name, getattr(tmodel, name)))
    toks = _tokens(30 + S, 1, S * jc.armt.segment_len, jc.vocab)
    jh, _ = jmodel.forward_hidden(jp, jc, jnp.asarray(toks), schedule="auto")
    th, _ = tmodel.forward_hidden(tp, tc, torch.from_numpy(toks), schedule="auto")
    want = "run_diagonal" if S >= L else "run_sequential"
    assert seen["jax"] == seen["torch"] == [want]
    np.testing.assert_allclose(np.asarray(jh), th.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("arch", ["llama-1b-armt", "llama-8b-armt", "falcon-mamba-7b"])
@pytest.mark.parametrize("B", [1, 2])
def test_sequential_fused_equals_diagonal_fused(arch, B):
    """Segmented mode, 3 segments: the sequential executor on the fused cell
    (a band of one layer; at B = 1 the fused down projection and update)
    against the diagonal executor on the fused cell, and against JAX's
    sequential executor."""
    jc, tc, jp, tp = _model(arch)
    seg = jc.armt.segment_len if jc.armt is not None else 16
    toks = _tokens(40 + B, B, 3 * seg, jc.vocab)
    kw = {} if jc.armt is not None else {"seg_len": seg}
    sh, sf = tmodel.forward_hidden(tp, tc, torch.from_numpy(toks), schedule="sequential",
                                   fused=True, **kw)
    dh, df = tmodel.forward_hidden(tp, tc, torch.from_numpy(toks), schedule="diagonal",
                                   fused=True, **kw)
    torch.testing.assert_close(sh, dh, atol=ATOL, rtol=RTOL)
    for k in sf["pattern"][0]:
        torch.testing.assert_close(sf["pattern"][0][k], df["pattern"][0][k],
                                   atol=ATOL, rtol=2e-3)
    jh, _ = jmodel.forward_hidden(jp, jc, jnp.asarray(toks), schedule="sequential", **kw)
    np.testing.assert_allclose(np.asarray(jh), sh.numpy(), atol=ATOL, rtol=RTOL)


def test_model_module_forwards_the_mode():
    _, tc, _, tp = _model("llama-1b-armt")
    toks = torch.from_numpy(_tokens(8, 1, N_TOKENS, tc.vocab))
    h, _ = tmodel.Model(tc, tp)(toks, mode="full")
    want, _ = tmodel.forward_hidden(tp, tc, toks, mode="full")
    torch.testing.assert_close(h, want, atol=0, rtol=0)
