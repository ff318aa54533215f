"""falcon-mamba in the port against the JAX reference at smoke size (fp32,
CPU): the config and parameter tree, forward_hidden under the diagonal
schedule (fused grouped cell and plain block slot by slot) and the
sequential one, decode token by token, ServeEngine.generate and serve, and
the parameter and state conversions' dtypes under bf16. Weights come from
the reference's init_params and go to the port through numpy."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.grouped_blocks import make_grouped_apply as j_grouped  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.kernels import mamba_scan as tscan  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.grouped_blocks import make_grouped_apply as t_grouped  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCH = "falcon-mamba-7b"
# fp32 on both sides through the whole stack
RTOL, ATOL = 1e-4, 5e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(want, got, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().cpu().float().numpy(), rtol=rtol, atol=atol)


_CACHE = {}


def _model(n_layers=None):
    if n_layers not in _CACHE:
        jc, tc = j_smoke(ARCH), t_smoke(ARCH)
        if n_layers:
            jc = dataclasses.replace(jc, n_layers=n_layers)
            tc = dataclasses.replace(tc, n_layers=n_layers)
        jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
        _CACHE[n_layers] = (jc, tc, jp, params_from_jax(_np(jp), "cpu"))
    return _CACHE[n_layers]


def _tokens(seed, B, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, n))


def test_config_matches_reference():
    from repro.configs import get_config as j_config
    for jc, tc in [(j_config(ARCH), get_config(ARCH)), (j_smoke(ARCH), t_smoke(ARCH))]:
        for f in ("n_layers", "d_model", "d_ff", "vocab", "block_pattern", "family",
                  "tie_embeddings", "norm", "act", "use_rope", "dtype"):
            assert getattr(jc, f) == getattr(tc, f), f
        assert dataclasses.asdict(jc.ssm) == dataclasses.asdict(tc.ssm)
        assert tc.armt is None and tc.is_recurrent == jc.is_recurrent is True
    from repro_torch.configs import falcon_mamba_7b
    assert falcon_mamba_7b.SEGMENT_LEN == tmodel.DEFAULT_SEG_LEN == 1024


def test_validate_keeps_refusing_what_the_port_lacks():
    tc = t_smoke(ARCH)
    for bad in (dataclasses.replace(tc, ssm=None), dataclasses.replace(tc, d_ff=64),
                dataclasses.replace(tc, block_pattern=("mamba", "attn")),
                dataclasses.replace(t_smoke("llama-1b-armt"), armt=None),
                dataclasses.replace(tc, block_pattern=("mamba_moe",))):
        with pytest.raises(ValueError):
            bad.validate()
    tc.validate()


def test_init_params_layout_and_dtypes_match_reference():
    jc, tc, jp, _ = _model()
    for dtype, tdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        mine = tmodel.init_params(dataclasses.replace(tc, dtype=dtype), 0, device="cpu")
        theirs = _np(jmodel.init_params(dataclasses.replace(jc, dtype=dtype),
                                        jax.random.PRNGKey(0)))
        shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
        assert shapes(theirs) == shapes(mine)
        mixer = mine["pattern"][0]["mixer"]
        assert mixer["A_log"].dtype == mixer["D"].dtype == torch.float32
        assert mixer["in_proj"].dtype == mixer["dt_bias"].dtype == tdt
        assert "mem_tokens" not in mine and "ffn" not in mine["pattern"][0]
        _close(theirs["pattern"][0]["mixer"]["A_log"], mixer["A_log"])
        assert torch.all(mixer["dt_bias"] == torch.tensor(-4.6, dtype=tdt))
    again = tmodel.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    torch.testing.assert_close(again["pattern"][0]["mixer"]["in_proj"],
                               tmodel.init_params(tc, 0, device="cpu")["pattern"][0]
                               ["mixer"]["in_proj"], rtol=0, atol=0)


def test_grouped_cell_matches_reference_vmap_cell():
    """The port's grouped mamba cell against the reference's grouped cell,
    which for mamba is vmap of the plain block over the band."""
    jc, tc, jp, tp = _model(4)
    rng = np.random.default_rng(3)
    G, B, T = 4, 2, 9
    dI, dS = 2 * jc.d_model, jc.ssm.d_state
    x = rng.standard_normal((G, B, T, jc.d_model)).astype(np.float32)
    st = {"h": (rng.standard_normal((G, B, dI, dS)) * 0.1).astype(np.float32),
          "conv": rng.standard_normal((G, B, 3, dI)).astype(np.float32)}
    jy, js = j_grouped(jc, use_kernel=True, interpret=True)(
        "mamba", jp["pattern"][0], jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    ty, ts = t_grouped(tc)("mamba", tp["pattern"][0], torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in st.items()})
    _close(jy, ty)
    for k in ("h", "conv"):
        _close(js[k], ts[k])


# (n_layers, S): S > L, S == L, S < L
@pytest.mark.parametrize("n_layers,S", [(2, 3), (2, 2), (4, 2)])
@pytest.mark.parametrize("schedule,fused", [("diagonal", True), ("diagonal", False),
                                            ("sequential", True)])
def test_forward_hidden_matches_reference(n_layers, S, schedule, fused):
    jc, tc, jp, tp = _model(n_layers if n_layers != 2 else None)
    seg = 16
    toks = _tokens(S + n_layers, 2, S * seg, jc.vocab)
    jh, jf = jmodel.forward_hidden(jp, jc, jnp.asarray(toks), schedule="sequential",
                                   seg_len=seg)
    th, tf = tmodel.forward_hidden(tp, tc, torch.from_numpy(toks), schedule=schedule,
                                   fused=fused, seg_len=seg)
    assert th.shape == jh.shape == (S, 2, seg, jc.d_model)
    _close(jh, th)
    for k in ("h", "conv"):
        _close(jf["pattern"][0][k], tf["pattern"][0][k])
    _close(jmodel.last_logits(jp, jc, jh), tmodel.last_logits(tp, tc, th))


def test_full_config_at_tiny_width_runs_every_entry_point():
    """falcon-mamba-7b as configured (no attention heads, untied head), cut
    to a tiny width: every entry point runs and the schedules agree."""
    tc = dataclasses.replace(get_config(ARCH), n_layers=3, d_model=32, vocab=64,
                             dtype="float32")
    tp = tmodel.init_params(tc, 0, device="cpu")
    toks = torch.from_numpy(_tokens(8, 1, 40, tc.vocab))
    dh, _ = tmodel.forward_hidden(tp, tc, toks, seg_len=8)
    sh, _ = tmodel.forward_hidden(tp, tc, toks, schedule="sequential", seg_len=8)
    torch.testing.assert_close(dh, sh, rtol=RTOL, atol=ATOL)
    res = ServeEngine(tp, tc, device="cpu", max_len=16).generate(toks.numpy(), 3)
    assert res.finite and res.tokens.shape == (1, 3)


def test_diagonal_equals_sequential_in_port():
    """The slot-by-slot plain block is the diagonal executor's oracle: equal
    to the sequential executor to the bit; the grouped cell within fp32."""
    _, tc, _, tp = _model(4)
    toks = torch.from_numpy(_tokens(7, 2, 3 * 16, tc.vocab))
    sh, sf = tmodel.forward_hidden(tp, tc, toks, schedule="sequential", fused=False,
                                   seg_len=16)
    oh, of = tmodel.forward_hidden(tp, tc, toks, schedule="diagonal", fused=False,
                                   seg_len=16)
    dh, df = tmodel.forward_hidden(tp, tc, toks, schedule="diagonal", seg_len=16)
    torch.testing.assert_close(oh, sh, rtol=0, atol=0)
    torch.testing.assert_close(of["pattern"][0]["h"], sf["pattern"][0]["h"], rtol=0, atol=0)
    torch.testing.assert_close(dh, sh, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(df["pattern"][0]["h"], sf["pattern"][0]["h"],
                               rtol=RTOL, atol=ATOL)


def test_decode_token_by_token_matches_prefill_and_reference():
    jc, tc, jp, tp = _model()
    B, P = 2, 11
    toks = _tokens(4, B, P, jc.vocab)
    hidden, fin = tmodel.forward_hidden(tp, tc, torch.from_numpy(toks), schedule="sequential")
    want = tmodel.last_logits(tp, tc, hidden)
    dt = tp["embed"].dtype
    st = tmodel.decode_state_init(tc, B, dtype=dt, device="cpu")
    assert set(st["pattern"][0]) == {"h", "conv"}      # no KV cache
    jst = jmodel.decode_state_init(jc, B, serve_mode="armt", max_len=64,
                                   dtype=jnp.float32)
    for t in range(P):
        logits, st = tmodel.decode_step(tp, tc, st, torch.from_numpy(toks[:, t]))
        jlogits, jst = jmodel.decode_step(jp, jc, jst, jnp.asarray(toks[:, t]))
        _close(jlogits, logits)
    assert st["pos"] == P
    torch.testing.assert_close(logits, want, rtol=RTOL, atol=ATOL)
    for k in ("h", "conv"):
        torch.testing.assert_close(st["pattern"][0][k], fin["pattern"][0][k],
                                   rtol=RTOL, atol=ATOL)
        _close(jst["pattern"][0][k], st["pattern"][0][k])
    with pytest.raises(ValueError, match="armt"):
        tmodel.flush_segment(tp, tc, st)


@pytest.fixture(scope="module")
def engines():
    jc, tc, jp, tp = _model()
    max_len = 32
    return (JEngine(jp, jc, serve_mode="armt", schedule="diagonal", max_len=max_len),
            ServeEngine(tp, tc, device="cpu", max_len=max_len), jc.vocab)


@pytest.mark.parametrize("B,n_full,tail", [(1, 3, 7), (2, 2, 0), (2, 0, 13)])
def test_generate_matches_reference(engines, B, n_full, tail):
    """Prompts of whole max_len pieces (through the diagonal prefill) plus a
    tail (through decode_step); the SSM engine never flushes."""
    jeng, teng, vocab = engines
    assert teng.seg_len == jeng.seg_len == 32 and not teng.flushes
    prompts = _tokens(10 * B + n_full + tail, B, n_full * 32 + tail, vocab)
    want = np.asarray(jeng.generate(jnp.asarray(prompts), 12).tokens)
    before = tscan.launches
    res = teng.generate(prompts, 12)
    assert tscan.launches == before                     # CPU: the plain version
    assert res.finite and res.prefill_segments == n_full
    np.testing.assert_array_equal(want, res.tokens)


def test_serve_matches_reference(engines):
    """6 requests on 2 slots, chunk 4, blocking admission on both sides
    (interleaved admission against blocking: tests/test_torch_interleave.py):
    prompts of 0-3 max_len pieces plus tails; the event streams are equal
    and no slot ever flushes."""
    jeng, teng, vocab = engines
    rng = np.random.default_rng(5)
    spec = [(40, 9), (70, 14), (5, 20), (96, 6), (33, 11), (1, 7)]
    reqs = [(i, rng.integers(0, vocab, n), m) for i, (n, m) in enumerate(spec)]
    want = [(e.req_id, int(e.token), e.index, e.done) for e in jeng.serve(
        [JRequest(i, p, m) for i, p, m in reqs], n_slots=2, chunk=4,
        prefill_groups_per_chunk=0)]
    got = list(teng.serve([Request(i, p, m) for i, p, m in reqs], n_slots=2, chunk=4,
                          prefill_groups_per_chunk=0))
    assert [(e.req_id, int(e.token), e.index, e.done) for e in got] == want
    assert sum(e.done for e in got) == len(spec) and all(e.finite for e in got if e.done)


def test_prefill_of_pieces_not_a_whole_number_of_segments():
    """max_len 600: two pieces are 1200 tokens, run as one 1024-token segment
    and one of 176 from the state it left; the logits and state equal
    feeding the same tokens through decode_step."""
    _, tc, _, tp = _model()
    eng = ServeEngine(tp, tc, device="cpu", max_len=600)
    toks = torch.from_numpy(_tokens(9, 1, 1200, tc.vocab))
    logits, dstate, pos, _ = eng.prefill(toks)
    st = tmodel.decode_state_init(tc, 1, dtype=torch.float32, device="cpu")
    want, st = tmodel.decode_step(tp, tc, st, toks)
    assert pos == 0
    torch.testing.assert_close(logits, want, rtol=RTOL, atol=ATOL)
    for k in ("h", "conv"):
        torch.testing.assert_close(dstate["pattern"][0][k], st["pattern"][0][k],
                                   rtol=RTOL, atol=ATOL)


def test_engine_refuses_attention_without_armt():
    tc = dataclasses.replace(t_smoke("llama-1b-armt"), armt=None)
    _, _, _, tp = _model()
    with pytest.raises(ValueError, match="recurrent"):
        ServeEngine(tp, tc, device="cpu")


def test_conversions_keep_each_leaf_role_under_bf16():
    """A_log, D and h stay fp32, the weights and the conv tail take the model
    dtype (bf16 here): a test in fp32 cannot see a conversion that casts
    every leaf to one dtype."""
    jc = dataclasses.replace(j_smoke(ARCH), dtype="bfloat16")
    jp = _np(jmodel.init_params(jc, jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, "cpu", torch.bfloat16)
    mixer = tp["pattern"][0]["mixer"]
    assert mixer["A_log"].dtype == mixer["D"].dtype == torch.float32
    assert all(mixer[k].dtype == torch.bfloat16
               for k in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
                         "out_proj"))
    assert tp["embed"].dtype == tp["head"].dtype == tp["pattern"][0]["ln1"]["w"].dtype \
        == torch.bfloat16
    jst = _np(jmodel.decode_state_init(jc, 2, serve_mode="armt", max_len=64,
                                       dtype=jnp.bfloat16))
    st = state_from_jax(jst, "cpu", torch.bfloat16)
    assert st["pattern"][0]["h"].dtype == torch.float32
    assert st["pattern"][0]["conv"].dtype == torch.bfloat16
    assert st["pos"] == 0
    mine = tmodel.decode_state_init(dataclasses.replace(t_smoke(ARCH), dtype="bfloat16"), 2,
                                    dtype=torch.bfloat16, device="cpu")
    for k in ("h", "conv"):
        assert mine["pattern"][0][k].dtype == st["pattern"][0][k].dtype
        assert mine["pattern"][0][k].shape == st["pattern"][0][k].shape
