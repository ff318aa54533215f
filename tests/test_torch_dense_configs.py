"""The five dense ARMT configs beside llama (minitron-8b, qwen2.5-32b with
its QKV bias, chameleon-34b with q/k norm, h2o-danube-1.8b with its sliding
window, chatglm3-6b with rotary on half the head dims and 16 q heads per kv
head at full width) against the JAX reference at smoke size (fp32, CPU):
the configs, the parameter tree, the attn block, the fused cell at B = 2
and B = 1, the diagonal executor on the fused cell and the decode step in
both serve modes. The reference's QKV biases and q/k norm weights are set
to seeded non-zero values before they go to the port, so that a dropped
bias or norm shows. Then the plain versions of the kernels at the shapes
these configs give them (head dim 80, 16:1 GQA) and the partial rotary."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.grouped_blocks import make_grouped_apply as j_grouped  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.core.sequential import layer_slice  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.grouped_blocks import make_grouped_apply as t_grouped  # noqa: E402

ARCHS = ["minitron-8b", "qwen2.5-32b", "chameleon-34b", "h2o-danube-1.8b", "chatglm3-6b"]
# fp32 against fp32 at "highest" matmul precision, as tests/test_torch_model.py:
# the ARMT recurrence amplifies summation-order differences segment by
# segment, so the tolerance is stated for <= 4 segments
ATOL, RTOL = 1e-4, 1e-3
# one attention call alone: fp32 softmax and products, summation order only
ATTN_ATOL = 1e-5


def _close(want, got, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().cpu().float().numpy(), atol=atol, rtol=rtol)


@pytest.fixture(params=ARCHS)
def arch(request):
    return request.param


def _nonzero_attn_leaves(jp, seed):
    """The reference's zero biases and unit q/k norm weights replaced by
    seeded values: biases normal x 0.1, norm weights 1 + normal x 0.1."""
    rng = np.random.default_rng(seed)
    attn = dict(jp["pattern"][0]["attn"])
    for b in ("bq", "bk", "bv"):
        if b in attn:
            attn[b] = jnp.asarray(rng.standard_normal(attn[b].shape).astype(np.float32) * 0.1)
    for n in ("qn", "kn"):
        if n in attn:
            w = attn[n]["w"]
            attn[n] = {"w": jnp.asarray(1 + rng.standard_normal(w.shape).astype(np.float32)
                                        * 0.1)}
    return {**jp, "pattern": ({**jp["pattern"][0], "attn": attn},)}


_CACHE = {}


def _model(arch):
    if arch not in _CACHE:
        jc, tc = j_smoke(arch), t_smoke(arch)
        jp = _nonzero_attn_leaves(jmodel.init_params(jc, jax.random.PRNGKey(0)), 7)
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        _CACHE[arch] = (jc, tc, jp, tp)
    return _CACHE[arch]


def _tokens(seed, B, n_tokens, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, n_tokens))


def _memory(rng, lead, P, D):
    return {"A": (rng.standard_normal(lead + (P, D)) * 0.1).astype(np.float32),
            "z": rng.uniform(size=lead + (P,)).astype(np.float32)}


def test_configs_match_reference(arch):
    """get_config and get_smoke_config equal the reference's in every field
    the port carries (the port leaves out the reference's training,
    sharding, MoE and encoder fields on purpose)."""
    for full, smoke in ((t_config(arch), j_config(arch)), (t_smoke(arch), j_smoke(arch))):
        mine, theirs = dataclasses.asdict(full), dataclasses.asdict(smoke)
        assert {k: v for k, v in theirs.items() if k in mine} == mine
    cfg = t_config(arch)
    assert (cfg.qkv_bias, cfg.qk_norm, cfg.rope_fraction) == {
        "qwen2.5-32b": (True, False, 1.0), "chameleon-34b": (False, True, 1.0),
        "chatglm3-6b": (True, False, 0.5)}.get(arch, (False, False, 1.0))


def test_param_tree_matches_reference(arch):
    """The port's init_params tree has the reference's leaves and shapes
    (bq/bk/bv zeros, qn/kn ones, stacked [n_super, ...]), and
    params_from_jax carries the reference's values across unchanged."""
    jc, tc, jp, tp = _model(arch)
    mine = tmodel.init_params(tc, 0, device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                    jmodel.init_params(jc, jax.random.PRNGKey(1)))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), mine) == shapes
    attn = mine["pattern"][0]["attn"]
    assert ("bq" in attn) == jc.qkv_bias and ("qn" in attn) == jc.qk_norm
    for b in ("bq", "bk", "bv"):
        if b in attn:
            assert not attn[b].any()
    for n in ("qn", "kn"):
        if n in attn:
            assert bool((attn[n]["w"] == 1).all())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        got = tp
        for key in path:
            got = got[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_array_equal(np.asarray(leaf), got.numpy())


def test_attn_block_matches_reference(arch):
    jc, tc, jp, tp = _model(arch)
    rng = np.random.default_rng(1)
    T = jc.armt.segment_len + jc.armt.num_mem_tokens
    x = rng.standard_normal((2, T, jc.d_model)).astype(np.float32)
    st = _memory(rng, (2,), 6 * jc.armt.d_mem, jc.d_model)
    jy, js = jblocks.make_apply_block(jc)(
        "attn", jax.tree_util.tree_map(lambda a: a[1], jp["pattern"][0]),
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    ty, ts = tblocks.make_apply_block(tc)(
        "attn", layer_slice(tp["pattern"][0], 1), torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in st.items()})
    _close(jy, ty)
    _close(js["A"], ts["A"])
    _close(js["z"], ts["z"])


@pytest.mark.parametrize("B", [2, 1])
def test_fused_cell_matches_reference_grouped_cell(arch, B):
    """The port's fused cell (CPU: the kernels' plain versions; the bias in
    the GEMM's epilogue) against the reference's fused cell running its
    Pallas kernels in interpret mode; at B = 1 both fuse the down
    projection with the ARMT update."""
    jc, tc, jp, tp = _model(arch)
    rng = np.random.default_rng(2 + B)
    G, T = jc.n_layers, jc.armt.segment_len + jc.armt.num_mem_tokens
    x = rng.standard_normal((G, B, T, jc.d_model)).astype(np.float32)
    st = _memory(rng, (G, B), 6 * jc.armt.d_mem, jc.d_model)
    jy, js = j_grouped(jc, use_kernel=True, interpret=True)(
        "attn", jp["pattern"][0], jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    ty, ts = t_grouped(tc)("attn", tp["pattern"][0], torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in st.items()})
    _close(jy, ty)
    _close(js["A"], ts["A"])
    _close(js["z"], ts["z"])


def test_fused_cell_with_layer_index_equals_band(arch):
    """With a layer index the cell reads the biases and q/k norm weights
    through it: the stack indexed [1, 0] equals the band in that order."""
    jc, tc, jp, tp = _model(arch)
    rng = np.random.default_rng(5)
    T = tc.armt.segment_len + tc.armt.num_mem_tokens
    x = torch.from_numpy(rng.standard_normal((2, 1, T, tc.d_model)).astype(np.float32))
    st = {k: torch.from_numpy(v) for k, v in
          _memory(rng, (2, 1), 6 * tc.armt.d_mem, tc.d_model).items()}
    order = torch.tensor([1, 0])
    band = jax.tree_util.tree_map(lambda t: t.index_select(0, order), tp["pattern"][0])
    cell = t_grouped(tc)
    want, wst = cell("attn", band, x, st)
    got, gst = cell("attn", tp["pattern"][0], x, st, order.to(torch.int32))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(gst["A"], wst["A"], atol=0, rtol=0)


def test_diagonal_fused_matches_reference_full_width(arch):
    """The port's diagonal executor on the fused cell against the
    reference's full-width diagonal driver (grouped_impl='vmap', no band
    skipping), 3 segments over 2 layers; the last logits too."""
    jc, tc, jp, tp = _model(arch)
    toks = _tokens(13, 2, 3 * jc.armt.segment_len, jc.vocab)
    jh, jf = jmodel.forward_hidden(jp, jc, jnp.asarray(toks), schedule="diagonal",
                                   grouped_impl="vmap")
    th, tf = tmodel.forward_hidden(tp, tc, torch.from_numpy(toks), schedule="diagonal",
                                   fused=True)
    assert th.shape == jh.shape
    _close(jh, th)
    _close(jf["pattern"][0]["z"], tf["pattern"][0]["z"], rtol=2e-3)
    _close(jmodel.last_logits(jp, jc, jh), tmodel.last_logits(tp, tc, th))


@pytest.mark.parametrize("serve_mode", ["armt", "cache"])
def test_decode_steps_match_reference(arch, serve_mode):
    """decode_step over 4 tokens after a 5-token chunk, in ARMT mode (from
    seeded memory, against the segment cache) and cache mode: logits and
    every state leaf."""
    jc, tc, jp, tp = _model(arch)
    B, max_len = 2, 32
    js = jmodel.decode_state_init(jc, B, serve_mode=serve_mode, max_len=max_len,
                                  dtype=jnp.float32)
    if serve_mode == "armt":
        rng = np.random.default_rng(9)
        mem = _memory(rng, js["pattern"][0]["A"].shape[:2], *js["pattern"][0]["A"].shape[2:])
        js = {**js, "pattern": ({**js["pattern"][0],
                                 **{k: jnp.asarray(v) for k, v in mem.items()}},)}
    ts = state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    toks = _tokens(17, B, 9, jc.vocab)
    feeds = [toks[:, :5]] + [toks[:, t] for t in range(5, 9)]
    for feed in feeds:
        jl, js = jmodel.decode_step(jp, jc, js, jnp.asarray(feed), serve_mode=serve_mode)
        tl, ts = tmodel.decode_step(tp, tc, ts, torch.from_numpy(feed),
                                    serve_mode=serve_mode)
        _close(jl, tl)
    want = state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    for k, leaf in want["pattern"][0].items():
        _close(leaf, ts["pattern"][0][k], rtol=2e-3)
    assert ts["pos"] == want["pos"]


# ---------------------------------------------------------------- plain versions
def test_flash_attention_plain_at_hd_80_with_window_matches_reference():
    """h2o-danube's head dim, 32 q heads over 8 kv heads, a window shorter
    than T."""
    rng = np.random.default_rng(80)
    q = rng.standard_normal((2, 32, 24, 80)).astype(np.float32)
    k, v = (rng.standard_normal((2, 8, 24, 80)).astype(np.float32) for _ in range(2))
    got = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                                  window=4)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=True, window=4)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=ATTN_ATOL, rtol=0)


def test_decode_attention_plain_at_16_heads_per_kv_head_matches_reference():
    """chatglm3-6b's grouping, 32 q heads over 2 kv heads, ragged lengths."""
    rng = np.random.default_rng(16)
    q = rng.standard_normal((3, 32, 16)).astype(np.float32)
    k, v = (rng.standard_normal((3, 40, 2, 16)).astype(np.float32) for _ in range(2))
    lengths = np.asarray([40, 9, 1], np.int32)
    got = ref.decode_attention_ref(*(torch.from_numpy(a) for a in (q, k, v, lengths)))
    want = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(lengths))
    np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("hd,fraction", [(16, 0.5), (8, 0.5), (10, 0.5), (16, 1.0)])
def test_apply_rope_matches_reference(hd, fraction):
    """Rotate-half over the leading int(hd * fraction) dims rounded down to
    even (hd 10 at one half: 4 of 10), the rest passed through bit for bit."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    pos = np.arange(7)[None] + np.asarray([[0], [100]])
    d_rot = tlayers.rope_dims(hd, fraction)
    jcos, jsin = jlayers.rope_cos_sin(jnp.asarray(pos), d_rot, 10000.0)
    tcos, tsin = tlayers.rope_cos_sin(torch.from_numpy(pos), d_rot, 10000.0)
    want = jlayers.apply_rope(jnp.asarray(x), jcos, jsin, fraction)
    got = tlayers.apply_rope(torch.from_numpy(x), tcos, tsin, fraction)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got[..., d_rot:].numpy(), x[..., d_rot:])
