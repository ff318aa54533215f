"""The blockwise cell FFN (``cfg.cell_block``) against the JAX reference at
smoke size (fp32, CPU): the plain attn block and the fused attn cell, at
cell_block 0, one that divides the segment's rows and one that does not,
against the reference's ``apply_block`` and
``make_grouped_apply(use_kernel=False)`` at the same value; cell_block = 0
against the unblocked formula to the bit; blocked against unblocked; a MoE
FFN never blocked; forward_hidden with a blocked FFN, diagonal against
sequential and against the reference; and the byte estimate's F-wide rows.
(jamba's mamba block with its dense FFN, blockwise, is held against the
reference in tests/test_torch_jamba.py.)

Inputs come from a numpy seed; the reference's weights go through
``convert.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.grouped_blocks import make_grouped_apply as j_grouped  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.sequential import layer_slice  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models.attention import rope_qk  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.grouped_blocks import make_grouped_apply as t_grouped  # noqa: E402
from repro_torch.models.layers import rmsnorm, swiglu  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

# one block or cell in fp32 against fp32: summation order only
ATOL = 1e-5
# forward_hidden over 3 segments: the ARMT recurrence amplifies those
# differences segment by segment (tests/test_torch_model.py's tolerance)
ATOL_FWD, RTOL_FWD = 1e-4, 1e-3
LLAMA = "llama-1b-armt"
# the smoke segment is 16 tokens + 4 memory tokens = 20 rows: 5 divides
# them, 8 does not (a short tail chunk of 4)
BLOCKS = [0, 5, 8]

_CACHE = {}


def _model(arch, n_layers=None):
    """(jax cfg, port cfg, jax params, port params) of the smoke config."""
    if (arch, n_layers) not in _CACHE:
        jc, tc = j_smoke(arch), t_smoke(arch)
        if n_layers:
            jc = dataclasses.replace(jc, n_layers=n_layers)
            tc = dataclasses.replace(tc, n_layers=n_layers)
        jp = jax.jit(lambda key: jmodel.init_params(jc, key))(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        _CACHE[arch, n_layers] = (jc, tc, jp, tp)
    return _CACHE[arch, n_layers]


def _blocked(jc, tc, cb):
    return dataclasses.replace(jc, cell_block=cb), dataclasses.replace(tc, cell_block=cb)


def _rows(cfg):
    return cfg.armt.segment_len + cfg.armt.num_mem_tokens


def _memory(rng, lead, cfg):
    P = 6 * cfg.armt.d_mem
    return {"A": (rng.standard_normal(lead + (P, cfg.d_model)) * 0.1).astype(np.float32),
            "z": rng.uniform(size=lead + (P,)).astype(np.float32)}


def _close(want, got, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().cpu().float().numpy(), atol=atol, rtol=rtol)


def _bits(a, b):
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_cell_block_field_and_validation():
    """The field defaults to 0 in every config, as the reference's; a
    negative value is refused."""
    assert t_smoke(LLAMA).cell_block == j_smoke(LLAMA).cell_block == 0
    assert t_config("jamba-1.5-large-398b").cell_block == 0
    with pytest.raises(ValueError, match="cell_block"):
        dataclasses.replace(t_config(LLAMA), cell_block=-1).validate()


# ---------------------------------------------------------------- the plain block
@pytest.mark.parametrize("cb", BLOCKS)
def test_plain_attn_block_matches_reference(cb):
    jc, tc, jp, tp = _model(LLAMA)
    jc, tc = _blocked(jc, tc, cb)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, _rows(tc), tc.d_model)).astype(np.float32)
    st = _memory(rng, (2,), tc)
    jy, js = jax.jit(lambda p, x, s: jblocks.make_apply_block(jc)("attn", p, x, s))(
        jax.tree_util.tree_map(lambda a: a[1], jp["pattern"][0]), jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in st.items()})
    ty, ts = tblocks.make_apply_block(tc)(
        "attn", layer_slice(tp["pattern"][0], 1), torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in st.items()})
    _close(jy, ty)
    _close(js["A"], ts["A"], rtol=1e-5)
    _close(js["z"], ts["z"], rtol=1e-5)


def test_cell_block_zero_is_the_unblocked_formula_to_the_bit():
    """cell_block = 0 (and a block of at least the segment's rows) is h +
    swiglu(rmsnorm(h)) of the whole segment, bit for bit: the output the
    port gave before the field existed."""
    jc, tc, jp, tp = _model(LLAMA)
    pl = layer_slice(tp["pattern"][0], 0)
    h = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, _rows(tc), tc.d_model)).astype(np.float32))
    want = h + swiglu(rmsnorm(h, pl["ln2"]), pl["ffn"])
    for cb in (0, _rows(tc), 64):
        _bits(tblocks.apply_ffn(tc, "attn", h, pl, cb), want)


def test_moe_ffn_is_never_blocked():
    """A MoE layer's FFN stays whole at any cell_block (its capacity
    couples the tokens): the attn_moe block and the fused attn_moe cell
    give cell_block = 0's output to the bit at cell_block 4."""
    tc = t_smoke("qwen2-moe-a2.7b")
    tp = tmodel.init_params(tc, 0, device="cpu")
    tb = dataclasses.replace(tc, cell_block=4)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 1, _rows(tc), tc.d_model))
                         .astype(np.float32))
    st = {k: torch.from_numpy(v) for k, v in _memory(rng, (2, 1), tc).items()}
    y0, s0 = t_grouped(tc)("attn_moe", tp["pattern"][0], x, st)
    y4, s4 = t_grouped(tb)("attn_moe", tp["pattern"][0], x, st)
    _bits(y4, y0)
    _bits(s4["A"], s0["A"])
    pl = layer_slice(tp["pattern"][0], 0)
    p0 = tblocks.make_apply_block(tc)("attn_moe", pl, x[0], layer_slice(st, 0))
    p4 = tblocks.make_apply_block(tb)("attn_moe", pl, x[0], layer_slice(st, 0))
    _bits(p4[0], p0[0])


# ---------------------------------------------------------------- the fused cell
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("cb", BLOCKS)
def test_fused_attn_cell_matches_reference(cb, B):
    """The fused attn cell over a band of both layers at cb (blocked, the
    B = 1 fused update is off) against the reference's grouped apply with
    the jnp oracles at the same cell_block."""
    jc, tc, jp, tp = _model(LLAMA)
    jc, tc = _blocked(jc, tc, cb)
    rng = np.random.default_rng(5 + B)
    G = tc.n_superblocks
    x = rng.standard_normal((G, B, _rows(tc), tc.d_model)).astype(np.float32)
    st = _memory(rng, (G, B), tc)
    jy, js = jax.jit(lambda p, x, s: j_grouped(jc, use_kernel=False)("attn", p, x, s))(
        jp["pattern"][0], jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    ty, ts = t_grouped(tc)("attn", tp["pattern"][0], torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in st.items()})
    _close(jy, ty)
    _close(js["A"], ts["A"], rtol=1e-5)
    _close(js["z"], ts["z"], rtol=1e-5)


@pytest.mark.parametrize("B", [1, 2])
def test_fused_cell_at_zero_is_the_unblocked_formula_and_blocked_is_close(B):
    """cell_block = 0's fused cell is the unblocked composition of the
    kernel entry points, bit for bit (the fused down projection and update
    at B = 1; the down projection and assoc_update at B = 2); a blocked
    cell (5 and 8) is within 1e-5 of it, output and memory; with a layer
    index the blocked cell equals the gathered band to the bit."""
    jc, tc, jp, tp = _model(LLAMA)
    p = tp["pattern"][0]
    rng = np.random.default_rng(9 + B)
    G, T, D = tc.n_superblocks, _rows(tc), tc.d_model
    x = torch.from_numpy(rng.standard_normal((G, B, T, D)).astype(np.float32))
    st = {k: torch.from_numpy(v) for k, v in _memory(rng, (G, B), tc).items()}
    y0, s0 = t_grouped(tc)("attn", p, x, st)

    # the cell composed by hand from the kernel entry points
    N, M, nu = G * B, tc.armt.num_mem_tokens, tc.armt.nu
    A_f, z_f = st["A"].reshape((N,) + st["A"].shape[2:]), st["z"].reshape(N, -1)
    xr = x + kops.assoc_read(x.reshape(N, T, D), p["mem"]["wq"], A_f, z_f,
                             nu=nu).reshape(G, B, T, D)
    pa = p["attn"]
    hln = rmsnorm(xr, {"w": p["ln1"]["w"][:, None, None, :]})
    hd = tc.head_dim
    q = kops.grouped_gemm(hln, pa["wq"]).reshape(G, B, T, tc.n_heads, hd)
    k = kops.grouped_gemm(hln, pa["wk"]).reshape(G, B, T, tc.n_kv_heads, hd)
    v = kops.grouped_gemm(hln, pa["wv"]).reshape(G, B, T, tc.n_kv_heads, hd)
    q, k = rope_qk(q, k, tc)
    o = kops.segment_attention(q, k, v, causal=True)
    h = xr + kops.grouped_gemm(o.reshape(G, B, T, -1), pa["wo"])
    pf = p["ffn"]
    h2 = rmsnorm(h, {"w": p["ln2"]["w"][:, None, None, :]})
    mid = kops.grouped_gemm(h2, pf["wg"], activation="silu") * kops.grouped_gemm(h2, pf["wu"])
    pm = p["mem"]
    if B == 1:
        y, A2, z2 = kops.grouped_gemm_armt_update(mid, pf["wd"], h, pm["wk"], pm["wv"],
                                                  pm["wb"], A_f, z_f, M=M, nu=nu)
    else:
        y = h + kops.grouped_gemm(mid, pf["wd"])
        A2, z2 = kops.assoc_update(y[:, :, -M:].reshape(N, M, D), pm["wk"], pm["wv"],
                                   pm["wb"], A_f, z_f, nu=nu)
    _bits(y0, y)
    _bits(s0["A"], A2.reshape(s0["A"].shape))
    _bits(s0["z"], z2.reshape(s0["z"].shape))
    order = torch.tensor([1, 0, 1], dtype=torch.int32)
    x3 = x.index_select(0, order.long())
    st3 = {kk: vv.index_select(0, order.long()) for kk, vv in st.items()}
    for cb in (5, 8):
        tb = dataclasses.replace(tc, cell_block=cb)
        yb, sb = t_grouped(tb)("attn", p, x, st)
        torch.testing.assert_close(yb, y0, atol=ATOL, rtol=0)
        torch.testing.assert_close(sb["A"], s0["A"], atol=ATOL, rtol=1e-5)
        torch.testing.assert_close(sb["z"], s0["z"], atol=ATOL, rtol=1e-5)
        band = jax.tree_util.tree_map(lambda t: t.index_select(0, order.long()), p)
        want, wst = t_grouped(tb)("attn", band, x3, st3)
        got, gst = t_grouped(tb)("attn", p, x3, st3, order)
        _bits(got, want)
        _bits(gst["A"], wst["A"])


# ---------------------------------------------------------------- model and estimate
@pytest.mark.parametrize("cb", [5, 8])
def test_forward_hidden_with_blocked_ffn(cb):
    """forward_hidden at cell_block cb, 3 segments at B = 1: diagonal equals
    sequential (plain, to the bit; fused within fp32 tolerance), both
    against the reference's sequential executor at the same cell_block,
    and within tolerance of cell_block = 0."""
    jc, tc, jp, tp = _model(LLAMA)
    jc, tc = _blocked(jc, tc, cb)
    toks = np.random.default_rng(13).integers(0, tc.vocab, (1, 3 * tc.armt.segment_len))
    jh, jf = jmodel.forward_hidden(jp, jc, jnp.asarray(toks), schedule="sequential")
    tk = torch.from_numpy(toks)
    hd, fd = tmodel.forward_hidden(tp, tc, tk, schedule="diagonal")
    hs, fs = tmodel.forward_hidden(tp, tc, tk, schedule="sequential")
    pd, pfd = tmodel.forward_hidden(tp, tc, tk, schedule="diagonal", fused=False)
    ps, pfs = tmodel.forward_hidden(tp, tc, tk, schedule="sequential", fused=False)
    _bits(pd, ps)
    _bits(pfd["pattern"][0]["A"], pfs["pattern"][0]["A"])
    torch.testing.assert_close(hd, hs, atol=ATOL_FWD, rtol=RTOL_FWD)
    for h, f in ((hd, fd), (pd, pfd)):
        _close(jh, h, atol=ATOL_FWD, rtol=RTOL_FWD)
        _close(jf["pattern"][0]["A"], f["pattern"][0]["A"], atol=ATOL_FWD, rtol=RTOL_FWD)
    h0, _ = tmodel.forward_hidden(tp, dataclasses.replace(tc, cell_block=0), tk)
    torch.testing.assert_close(hd, h0, atol=ATOL_FWD, rtol=RTOL_FWD)


def test_byte_estimate_counts_the_blocked_rows():
    """prefill_activation_bytes counts a blocked FFN's F-wide intermediates
    at cell_block rows: llama-1b-armt at its full width (an engine on the
    meta device, no weights drawn) estimates less at cell_block 256 than
    at 0, by the F-wide rows it no longer holds at once, less the blocked
    cell's one more D-wide output."""
    cfg = t_config(LLAMA)
    params = {"embed": torch.empty(cfg.vocab, cfg.d_model, dtype=torch.bfloat16,
                                   device="meta"), "prelude": (), "pattern": ()}
    est = {cb: ServeEngine(params, dataclasses.replace(cfg, cell_block=cb),
                           device="meta").prefill_activation_bytes(16)
           for cb in (0, 256)}
    T, F, G = _rows(cfg), cfg.d_ff, cfg.n_layers
    saved = G * (T - 256) * 3 * F * 2 - G * T * cfg.d_model * 2
    assert est[0] - est[256] == saved > 0
