"""whisper-medium, the encoder-decoder, against the JAX reference at smoke
size (``get_smoke_config``: 2 encoder and 2 decoder layers, d_model 32, 16
frames, segments of 16 tokens with 4 memory tokens; fp32, CPU): the config
and parameter tree, layernorm and the GELU MLP, the cross K/V and the
cross-attention, the ``enc`` and ``dec`` blocks, ``encode``;
``forward_hidden`` with frames in both schedules and both modes; the fused
``enc`` and ``dec`` cells against the plain block (``cell_block`` 0 and
> 0); decode and the flush from a decode state whose cross K/V the
reference's own ``encode`` and ``_fill_cross_kv`` filled; greedy
``generate`` across a flush in both serve modes against a reference built
from JAX functions only; and the reference's serving fault: its
``ServeEngine.prefill`` leaves every ``ck``/``cv`` at zero, so its
cache-mode tokens ignore the frames, where the port's do not.

The reference's weights are drawn once; every bias and norm leaf is then
set away from its init value (zeros and ones would hide a missing bias),
and the same numpy tree goes to both packages. Each reference result is
computed once per module. Inputs come from a numpy seed."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.core.diagonal import _per_slot_apply  # noqa: E402
from repro_torch.core.sequential import layer_slice  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.grouped_blocks import make_grouped_apply  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCH = "whisper-medium"
# fp32 against fp32: one function is summation order only; a model over
# several segments is held as the other configs are (the ARMT recurrence
# grows the differences segment by segment)
ATOL_ONE = 1e-5
ATOL, RTOL = 1e-4, 1e-3
SEG, B = 16, 2
BIASES = {"bq", "bk", "bv", "bi", "bo", "b"}


def _close(want, got, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().cpu().float().numpy(), atol=atol, rtol=rtol)


def _bits(a, b):
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def m():
    """The smoke model in both packages, the inputs, and a cache of the
    reference's results (each computed once)."""
    jc, tc = j_smoke(ARCH), t_smoke(ARCH)
    jp = jax.jit(lambda key: jmodel.init_params(jc, key))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        name = path[-1].key if hasattr(path[-1], "key") else None
        a = np.asarray(a, np.float32)
        if name in BIASES:
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "w":               # the norms' weights
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a
    np_p = jax.tree_util.tree_map_with_path(perturb, jp)
    frames = rng.standard_normal((2, B, jc.encoder.n_frames, jc.d_model)).astype(np.float32)
    return dict(jc=jc, tc=tc, jp=jax.tree_util.tree_map(jnp.asarray, np_p),
                tp=params_from_jax(np_p, "cpu"), frames=frames, rng=rng, ref={})


def _ref(m, key, fn):
    if key not in m["ref"]:
        m["ref"][key] = fn()
    return m["ref"][key]


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _j_enc(m, f=0):
    jc = m["jc"]
    return _ref(m, ("enc", f), lambda: jax.jit(lambda p, x: jmodel.encode(p, jc, x))(
        m["jp"], jnp.asarray(m["frames"][f])))


def _j_fns(m, serve_mode):
    """The reference's decode_step and flush_segment, jitted once."""
    jc = m["jc"]
    return _ref(m, ("fns", serve_mode), lambda: (
        jax.jit(lambda p, s, t: jmodel.decode_step(p, jc, s, t, serve_mode=serve_mode)),
        jax.jit(lambda p, s: jmodel.flush_segment(p, jc, s))))


def _j_filled_dstate(m, serve_mode, batch=B, f=0, max_len=64):
    """The reference's decode state with its cross K/V filled by its own
    encode and _fill_cross_kv (which drops pos; put back)."""
    jc = m["jc"]
    st = jmodel.decode_state_init(jc, batch, serve_mode=serve_mode, max_len=max_len,
                                  dtype=jnp.float32)
    fill = _ref(m, "fill", lambda: jax.jit(lambda p, s, e: jmodel._fill_cross_kv(p, jc, s, e)))
    return dict(fill(m["jp"], st, _j_enc(m, f)[:batch]), pos=st["pos"])


# ---------------------------------------------------------------- config, params
def test_config_param_tree_and_validate():
    """get_config and get_smoke_config equal the reference's in every field
    the port carries; init_params has the reference's leaves and shapes
    (the enc tree, pos_embed, the dec blocks' ln_x and xattn, the biases
    layernorm implies); params_from_jax keeps that layout; validate()
    refuses the other norm/activation/encoder combinations."""
    for mine, theirs in ((t_config(ARCH), j_config(ARCH)), (t_smoke(ARCH), j_smoke(ARCH))):
        mm, tt = dataclasses.asdict(mine), dataclasses.asdict(theirs)
        assert {k: v for k, v in tt.items() if k in mm} == mm
    jc, tc = j_smoke(ARCH), t_smoke(ARCH)
    jp = jax.eval_shape(lambda k: jmodel.init_params(jc, k), jax.random.PRNGKey(0))
    mine = tmodel.init_params(tc, 0, device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), mine) == shapes
    conv = params_from_jax(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), jp), "cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), conv) == shapes
    assert mine["pos_embed"].shape == (tc.max_position, tc.d_model)
    assert set(mine["enc"]) == {"blocks", "final_norm", "pos"}
    bad = [dataclasses.replace(tc, encoder=None),
           dataclasses.replace(tc, norm="rmsnorm"),
           dataclasses.replace(tc, act="silu"),
           dataclasses.replace(tc, use_rope=True),
           dataclasses.replace(tc, armt=None),
           dataclasses.replace(tc, block_pattern=("attn",)),
           dataclasses.replace(t_smoke("llama-1b-armt"), norm="layernorm"),
           dataclasses.replace(t_smoke("llama-1b-armt"), encoder=tc.encoder)]
    for c in bad:
        with pytest.raises(ValueError):
            c.validate()


# ---------------------------------------------------------------- the functions
@pytest.mark.parametrize("what", ["layernorm", "mlp_gelu", "cross_kv", "cross_attention",
                                  "enc_block", "dec_block", "encode"])
def test_function_matches_reference(m, what):
    """Each whisper function of the port against the reference's on the
    same weights and inputs, within 1e-5: layernorm and the GELU MLP
    (decoder layer 0's ln2 and FFN, biases included), cross_kv and
    cross_attention (layer 0's xattn against the reference's encoder
    output), the enc block (bidirectional, no memory), the dec block
    (memory read, causal self-attention, cross-attention, FFN, the update),
    and encode."""
    jc, tc, jp, tp = m["jc"], m["tc"], m["jp"], m["tp"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, SEG + 4, jc.d_model)).astype(np.float32)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["pattern"][0])
    tl = layer_slice(tp["pattern"][0], 0)
    enc = np.asarray(_j_enc(m))
    if what == "layernorm":
        want, got = jlayers.layernorm(jnp.asarray(x), jl["ln2"]), tlayers.layernorm(_t(x), tl["ln2"])
    elif what == "mlp_gelu":
        want, got = jlayers.mlp_gelu(jnp.asarray(x), jl["ffn"]), tlayers.mlp_gelu(_t(x), tl["ffn"])
    elif what == "cross_kv":
        want = jattn.cross_kv(jnp.asarray(enc), jl["xattn"], jc)
        got = tattn.cross_kv(_t(enc), tl["xattn"], tc)
        _close(want[0], got[0], ATOL_ONE, ATOL_ONE)
        want, got = want[1], got[1]
    elif what == "cross_attention":
        ck, cv = jattn.cross_kv(jnp.asarray(enc), jl["xattn"], jc)
        want = jattn.cross_attention(jnp.asarray(x), jl["xattn"], ck, cv, jc)
        tck, tcv = _t(ck), _t(cv)
        got = tattn.cross_attention(_t(x), tl["xattn"], tck, tcv, tc)
        # the decode path's kernel form (one token; a chunk) computes the same
        _close(want, tattn.decode_cross_attention(_t(x), tl["xattn"], tck, tcv, tc),
               ATOL_ONE, ATOL_ONE)
        _close(want[:, :1], tattn.decode_cross_attention(_t(x[:, :1]), tl["xattn"], tck,
                                                        tcv, tc), ATOL_ONE, ATOL_ONE)
    elif what == "enc_block":
        je = jax.tree_util.tree_map(lambda a: a[0], jp["enc"]["blocks"])
        want, _ = jblocks.make_apply_block(jc, mode="full")("enc", je, jnp.asarray(x), {})
        got, st = tblocks.make_apply_block(tc, "full")("enc", layer_slice(tp["enc"]["blocks"], 0),
                                                       _t(x), {})
        assert st == {}
    elif what == "dec_block":
        jst = jax.tree_util.tree_map(lambda a: a[0], _j_filled_dstate(m, "armt")["pattern"][0])
        jst = {k: jst[k] for k in ("A", "z", "ck", "cv")}
        jst["A"] = jnp.asarray(rng.standard_normal(jst["A"].shape).astype(np.float32)) * 0.1
        jst["z"] = jnp.abs(jnp.asarray(rng.standard_normal(jst["z"].shape).astype(np.float32)))
        want, wst = jax.jit(lambda p, x_, s_: jblocks.make_apply_block(jc)("dec", p, x_, s_))(
            jl, jnp.asarray(x), jst)
        tst = state_from_jax(jax.tree_util.tree_map(np.asarray, jst), "cpu")
        got, gst = tblocks.make_apply_block(tc)("dec", tl, _t(x), tst)
        for k in ("A", "z"):
            _close(wst[k], gst[k], ATOL_ONE, ATOL_ONE)
        assert gst["ck"] is tst["ck"] and gst["cv"] is tst["cv"]
    else:
        want = _j_enc(m)
        got = tmodel.encode(tp, tc, _t(m["frames"][0]))
        _bits(got, tmodel.encode(tp, tc, _t(m["frames"][0]), fused=False))
    _close(want, got, ATOL_ONE, ATOL_ONE)


# ---------------------------------------------------------------- the forward
@pytest.mark.parametrize("mode", ["segmented", "full"])
def test_forward_hidden_matches_reference(m, mode):
    """forward_hidden with frames (3 segments of 16 tokens, B = 2) against
    the reference's sequential forward within 1e-4, the final A, z and
    cross K/V too; in the port the diagonal, sequential and auto
    schedules, fused and plain, agree to the bit."""
    jc, tc = m["jc"], m["tc"]
    tk = _tokens(2, (B, 3 * SEG), jc.vocab)
    fr = m["frames"][0]
    want = _ref(m, ("fwd", mode), lambda: jax.jit(
        lambda p, t, f: jmodel.forward_hidden(p, jc, t, schedule="sequential", mode=mode,
                                              enc_frames=f))(m["jp"], jnp.asarray(tk),
                                                             jnp.asarray(fr)))
    outs = {}
    with torch.no_grad():
        for schedule in ("diagonal", "sequential", "auto"):
            for fused in (True, False):
                outs[schedule, fused] = tmodel.forward_hidden(
                    m["tp"], tc, torch.from_numpy(tk), schedule=schedule, fused=fused,
                    mode=mode, enc_frames=_t(fr))
    hd, fd = outs["diagonal", True]
    _close(want[0], hd)
    for k in ("A", "z"):
        if mode == "segmented":
            _close(want[1]["pattern"][0][k], fd["pattern"][0][k],
                   ATOL * max(1.0, float(np.abs(np.asarray(want[1]["pattern"][0][k])).max())),
                   2e-3)
    _close(want[1]["pattern"][0]["ck"], fd["pattern"][0]["ck"])
    for key, (h, f) in outs.items():
        _bits(hd, h)
        for k in fd["pattern"][0]:
            _bits(fd["pattern"][0][k], f["pattern"][0][k])


def test_forward_hidden_takes_frames_or_a_state():
    """A whisper forward needs the frames or a state holding the cross K/V,
    not both and not neither; a model without an encoder refuses frames;
    a state0 sharing a filled state's ck/cv (init_state(cross_from=))
    gives the frames' forward to the bit, and neither executor copies or
    writes ck/cv (each schedule against its own frames' run: on the CPU a
    band of another width may round differently)."""
    tc = t_smoke(ARCH)
    tp = tmodel.init_params(tc, 3, device="cpu")
    tk = torch.from_numpy(_tokens(4, (1, 2 * SEG), tc.vocab))
    fr = torch.randn(1, tc.encoder.n_frames, tc.d_model)
    with pytest.raises(ValueError, match="enc_frames"):
        tmodel.forward_hidden(tp, tc, tk)
    filled = tmodel.init_state(tc, 1, "cpu")
    tmodel.fill_cross_kv_(tp, tc, filled, tmodel.encode(tp, tc, fr))
    with pytest.raises(ValueError, match="one of the two"):
        tmodel.forward_hidden(tp, tc, tk, enc_frames=fr, state0=filled)
    lc = t_smoke("llama-1b-armt")
    with pytest.raises(ValueError, match="no encoder"):
        tmodel.forward_hidden(tmodel.init_params(lc, 0, device="cpu"), lc,
                              torch.zeros(1, 16, dtype=torch.long), enc_frames=fr)
    with torch.no_grad():
        for schedule in ("diagonal", "sequential"):
            h0, f0 = tmodel.forward_hidden(tp, tc, tk, enc_frames=fr, schedule=schedule)
            st0 = tmodel.init_state(tc, 1, "cpu", cross_from=filled)
            ck = st0["pattern"][0]["ck"]
            before = ck.clone()
            h, f = tmodel.forward_hidden(tp, tc, tk, state0=st0, schedule=schedule)
            _bits(h0, h)
            assert f["pattern"][0]["ck"] is ck and ck is filled["pattern"][0]["ck"]
            _bits(before, ck)
            _bits(f0["pattern"][0]["A"], f["pattern"][0]["A"])


@pytest.mark.parametrize("cell_block,batch", [(0, 1), (0, 2), (8, 1), (8, 2)])
def test_fused_cells_match_plain_block(m, cell_block, batch):
    """The fused dec cell over a band of both decoder layers (G = 2) against
    the plain block slot by slot, and with a layer index, within 1e-5; at
    B = 1 without cell_block its FFN's down projection (bias bo) is the
    fused update, else the GEMM and armt_update. The enc cell (G = 1)
    against the plain enc block."""
    tc = dataclasses.replace(m["tc"], cell_block=cell_block)
    tp = m["tp"]
    rng = np.random.default_rng(5)
    G, T = 2, SEG + 4
    x = _t(rng.standard_normal((G, batch, T, tc.d_model)))
    st = tmodel.init_state(tc, batch, "cpu")["pattern"][0]
    st["A"] = _t(0.1 * rng.standard_normal(st["A"].shape))
    st["z"] = _t(np.abs(rng.standard_normal(st["z"].shape)))
    enc = tmodel.encode(tp, tc, _t(m["frames"][0][:batch]))
    tmodel.fill_cross_kv_(tp, tc, {"prelude": (), "pattern": (st,)}, enc)
    cell = make_grouped_apply(tc)
    plain = _per_slot_apply(tblocks.make_apply_block(tc))
    with torch.no_grad():
        y, new = cell("dec", tp["pattern"][0], x, st)
        yi, newi = cell("dec", tp["pattern"][0], x, st,
                        widx=torch.arange(G, dtype=torch.int32))
        want, wnew = plain("dec", tp["pattern"][0], x, st)
        _close(want, y, ATOL_ONE, ATOL_ONE)
        _bits(y, yi)
        for k in ("A", "z"):
            _close(wnew[k], new[k], ATOL_ONE, ATOL_ONE)
            _bits(new[k], newi[k])
        xe = x[:1]
        ye, _ = cell("enc", jax.tree_util.tree_map(lambda a: a[:1], tp["enc"]["blocks"]),
                     xe, {})
        we, _ = tblocks.make_apply_block(tc, "full")("enc", layer_slice(tp["enc"]["blocks"], 0),
                                                     xe[0], {})
    _close(we, ye[0], ATOL_ONE, ATOL_ONE)


# ---------------------------------------------------------------- decode
@pytest.mark.parametrize("serve_mode", ["armt", "cache"])
def test_decode_and_flush_match_reference(m, serve_mode):
    """From a decode state whose ck/cv the reference's encode and
    _fill_cross_kv filled: a 5-token chunk at pos 0, two single tokens and
    (armt) a flush at pos 7, then one more token, against the reference's
    decode_step and flush_segment: logits and every leaf within 1e-4 (the
    learned positions are read at the in-segment pos, the flush's memory
    rows at pos..pos+M-1)."""
    jc, tc = m["jc"], m["tc"]
    jst = _j_filled_dstate(m, serve_mode)
    tst = state_from_jax(jax.tree_util.tree_map(np.asarray, jst), "cpu")
    feeds = [_tokens(6, (B, 5), jc.vocab), _tokens(7, (B,), jc.vocab),
             _tokens(8, (B,), jc.vocab), "flush", _tokens(9, (B,), jc.vocab)]

    step, flush = _j_fns(m, serve_mode)

    def jrun():
        st, out = jst, []
        for f in feeds:
            if isinstance(f, str):
                if serve_mode == "armt":
                    st = flush(m["jp"], st)
                continue
            lg, st = step(m["jp"], st, jnp.asarray(f))
            out.append(lg)
        return out, st
    wl, wst = _ref(m, ("decode", serve_mode), jrun)
    gl = []
    with torch.no_grad():
        for f in feeds:
            if isinstance(f, str):
                if serve_mode == "armt":
                    tst = tmodel.flush_segment(m["tp"], tc, tst)
                continue
            lg, tst = tmodel.decode_step(m["tp"], tc, tst, torch.from_numpy(f),
                                         serve_mode=serve_mode)
            gl.append(lg)
    for w, g in zip(wl, gl):
        _close(w, g)
    assert tst["pos"] == int(wst["pos"])
    for k, w in wst["pattern"][0].items():
        scale = max(1.0, float(np.abs(np.asarray(w)).max())) if k in ("A", "z") else 1.0
        _close(w, tst["pattern"][0][k], ATOL * scale)


def _j_generate(m, prompt, max_new, serve_mode, f=0):
    """Greedy generation built from the reference's functions only: the
    whole segments through forward_hidden (armt), a decode state with the
    final memory transplanted and the cross K/V filled from encode, the
    rest of the prompt as one decode_step chunk, then a decode_step per
    token with a flush_segment at every segment boundary."""
    jc, jp = m["jc"], m["jp"]
    step, flush = _j_fns(m, serve_mode)
    Bn, P = prompt.shape
    fr = jnp.asarray(m["frames"][f][:Bn])
    st = _j_filled_dstate(m, serve_mode, Bn, f)
    n_full = P // SEG if serve_mode == "armt" else 0
    if n_full:
        _, fin = jax.jit(lambda p, t, fr_: jmodel.forward_hidden(p, jc, t, enc_frames=fr_))(
            jp, jnp.asarray(prompt[:, :n_full * SEG]), fr)
        st = jengine._transplant(fin, st)
    logits, st = step(jp, st, jnp.asarray(prompt[:, n_full * SEG:]))
    pos = P - n_full * SEG
    toks = [np.asarray(jnp.argmax(logits, -1))]
    for _ in range(1, max_new):
        logits, st = step(jp, st, jnp.asarray(toks[-1]))
        pos += 1
        if serve_mode == "armt" and pos >= SEG:
            st = flush(jp, st)
            pos = 0
        toks.append(np.asarray(jnp.argmax(logits, -1)))
    return np.stack(toks, 1)


@pytest.mark.parametrize("serve_mode", ["armt", "cache"])
def test_generate_matches_reference_built_from_functions(m, serve_mode):
    """ServeEngine.generate(enc_frames=) of B = 2 prompts of 16 + 5 tokens,
    14 new (a flush at the 12th in armt mode), greedy, against the
    reference's functions run as a generate loop: the same tokens."""
    tc = m["tc"]
    prompt = _tokens(10, (B, SEG + 5), tc.vocab)
    want = _ref(m, ("gen", serve_mode), lambda: _j_generate(m, prompt, 14, serve_mode))
    eng = ServeEngine(m["tp"], tc, serve_mode=serve_mode, max_len=64, device="cpu")
    res = eng.generate(prompt, 14, enc_frames=m["frames"][0])
    np.testing.assert_array_equal(res.tokens, want)


def test_reference_prefill_drops_cross_kv_and_the_port_fills_it(m):
    """The reference's fault: its ServeEngine.prefill(enc_frames=) leaves
    every ck/cv at zero in both serve modes (its transplant copies only
    the recurrent leaves, and cache mode never runs the encoder), so its
    cache-mode greedy tokens are the same for two sets of frames. The
    port's prefill fills ck/cv (the reference's own encode + _fill_cross_kv
    within 1e-5) and its tokens, logits included, follow the frames."""
    jc, tc = m["jc"], m["tc"]
    prompt = _tokens(11, (1, SEG + 5), tc.vocab)
    for serve_mode in ("armt", "cache"):
        jeng = jengine.ServeEngine(m["jp"], jc, serve_mode=serve_mode, max_len=64,
                                   bucket_prompts=False)
        _, jst = jeng.prefill(jnp.asarray(prompt), enc_frames=jnp.asarray(m["frames"][0][:1]))
        assert all(float(jnp.abs(jst["pattern"][0][k]).max()) == 0.0 for k in ("ck", "cv"))
        eng = ServeEngine(m["tp"], tc, serve_mode=serve_mode, max_len=64, device="cpu")
        _, tst, _, _ = eng.prefill(torch.from_numpy(prompt), enc_frames=m["frames"][0][:1])
        want = _j_filled_dstate(m, serve_mode, 1)
        for k in ("ck", "cv"):
            _close(want["pattern"][0][k], tst["pattern"][0][k], ATOL_ONE, ATOL_ONE)
    # the loop's last engine is the cache-mode one
    jt = [jeng.generate(jnp.asarray(prompt), 6, enc_frames=jnp.asarray(m["frames"][f][:1])).tokens
          for f in (0, 1)]
    np.testing.assert_array_equal(jt[0], jt[1])
    eng = ServeEngine(m["tp"], tc, serve_mode="cache", max_len=64, device="cpu")
    mine = [eng.generate(prompt, 6, enc_frames=m["frames"][f][:1], keep=True) for f in (0, 1)]
    assert not np.array_equal(mine[0].tokens, mine[1].tokens)
    assert not torch.equal(mine[0].logits, mine[1].logits)


def test_engine_refuses_what_whisper_does_not_have():
    """An encoder config's engine refuses serve() and interleaved
    admission (the scheduler takes no frames), sessions, and a prompt
    without frames; another config refuses frames."""
    tc = t_smoke(ARCH)
    eng = ServeEngine(tmodel.init_params(tc, 0, device="cpu"), tc, device="cpu")
    prompt = _tokens(12, (1, 20), tc.vocab)
    fr = np.zeros((1, tc.encoder.n_frames, tc.d_model), np.float32)
    with pytest.raises(ValueError, match="serve"):
        list(eng.serve([Request(0, prompt[0], 4)]))
    with pytest.raises(ValueError, match="admission"):
        eng.start_prefill(prompt)
    with pytest.raises(ValueError, match="session"):
        eng.generate(prompt, 4, enc_frames=fr, session_id="s")
    with pytest.raises(ValueError, match="enc_frames"):
        eng.generate(prompt, 4)
    lc = t_smoke("llama-1b-armt")
    leng = ServeEngine(tmodel.init_params(lc, 0, device="cpu"), lc, device="cpu")
    with pytest.raises(ValueError, match="enc_frames"):
        leng.generate(prompt, 4, enc_frames=fr)
