"""The port's model against the JAX reference at smoke size (fp32, CPU):
the attn block, the sequential and diagonal executors, the fused grouped
cell and last_logits, for each Llama ARMT config (llama-8b-armt with its
untied head). Weights come from the reference's init_params and go to the
port through numpy (repro_torch.convert)."""
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
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.core.sequential import layer_slice  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.grouped_blocks import make_grouped_apply as t_grouped  # noqa: E402

ARCHS = ["llama-1b-armt", "llama-160m-armt", "llama-3b-armt", "llama-8b-armt"]
# fp32 against fp32 at "highest" matmul precision. The ARMT recurrence
# amplifies summation-order differences segment by segment (the reference's
# DESIGN.md §7), so the tolerance is stated for <= 4 segments.
ATOL, RTOL = 1e-4, 1e-3


def _close(want, got, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().cpu().float().numpy(),
                               atol=atol, rtol=rtol)


@pytest.fixture(params=ARCHS)
def arch(request):
    return request.param


def _configs(arch, n_layers=None):
    jc, tc = j_smoke(arch), t_smoke(arch)
    if n_layers:
        jc = dataclasses.replace(jc, n_layers=n_layers)
        tc = dataclasses.replace(tc, n_layers=n_layers)
    return jc, tc


_CACHE = {}


def _model(arch, n_layers=None):
    if (arch, n_layers) not in _CACHE:
        jc, tc = _configs(arch, n_layers)
        jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        _CACHE[arch, n_layers] = (jc, tc, jp, tp)
    return _CACHE[arch, n_layers]


def _tokens(seed, B, n_tokens, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, n_tokens))


def test_smoke_config_matches_reference(arch):
    jc, tc = _configs(arch)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "vocab", "rope_theta", "tie_embeddings", "block_pattern", "dtype"):
        assert getattr(jc, f) == getattr(tc, f), f
    assert dataclasses.asdict(jc.armt) == dataclasses.asdict(tc.armt)


def test_attn_block_matches_make_apply_block(arch):
    jc, tc, jp, tp = _model(arch)
    rng = np.random.default_rng(1)
    T = jc.armt.segment_len + jc.armt.num_mem_tokens
    x = rng.standard_normal((2, T, jc.d_model)).astype(np.float32)
    P = 6 * jc.armt.d_mem
    st = {"A": (rng.standard_normal((2, P, jc.d_model)) * 0.1).astype(np.float32),
          "z": rng.uniform(size=(2, P)).astype(np.float32)}
    jy, js = jblocks.make_apply_block(jc)(
        "attn", jax.tree_util.tree_map(lambda a: a[1], jp["pattern"][0]),
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    ty, ts = tblocks.make_apply_block(tc)(
        "attn", layer_slice(tp["pattern"][0], 1), torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in st.items()})
    _close(jy, ty)
    _close(js["A"], ts["A"])
    _close(js["z"], ts["z"])


def test_fused_cell_matches_reference_grouped_cell(arch):
    """The port's fused cell (CPU: the kernels' plain versions) against the
    reference fused cell running its Pallas kernels in interpret mode."""
    jc, tc, jp, tp = _model(arch)
    rng = np.random.default_rng(2)
    G, B = jc.n_layers, 2
    T = jc.armt.segment_len + jc.armt.num_mem_tokens
    x = rng.standard_normal((G, B, T, jc.d_model)).astype(np.float32)
    P = 6 * jc.armt.d_mem
    st = {"A": (rng.standard_normal((G, B, P, jc.d_model)) * 0.1).astype(np.float32),
          "z": rng.uniform(size=(G, B, P)).astype(np.float32)}
    jy, js = j_grouped(jc, use_kernel=True, interpret=True)(
        "attn", jp["pattern"][0], jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in st.items()})
    ty, ts = t_grouped(tc)("attn", tp["pattern"][0], torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in st.items()})
    _close(jy, ty)
    _close(js["A"], ts["A"])
    _close(js["z"], ts["z"])


def test_fused_cell_at_batch_one_matches_reference_fused_update(arch):
    """At B = 1 both cells run the down projection with the ARMT update
    fused (the reference's grouped_matmul_armt_update in interpret mode,
    the port's grouped_gemm_armt_update on the CPU)."""
    jc, tc, jp, tp = _model(arch)
    rng = np.random.default_rng(3)
    G, T = jc.n_layers, jc.armt.segment_len + jc.armt.num_mem_tokens
    x = rng.standard_normal((G, 1, T, jc.d_model)).astype(np.float32)
    P = 6 * jc.armt.d_mem
    st = {"A": (rng.standard_normal((G, 1, P, jc.d_model)) * 0.1).astype(np.float32),
          "z": rng.uniform(size=(G, 1, P)).astype(np.float32)}
    jy, js = j_grouped(jc, use_kernel=True, interpret=True)(
        "attn", jp["pattern"][0], jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in st.items()})
    ty, ts = t_grouped(tc)("attn", tp["pattern"][0], torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in st.items()})
    _close(jy, ty)
    _close(js["A"], ts["A"])
    _close(js["z"], ts["z"])


@pytest.mark.parametrize("S", [1, 3])
def test_sequential_matches_reference(arch, S):
    jc, tc, jp, tp = _model(arch)
    toks = _tokens(S, 2, S * jc.armt.segment_len, jc.vocab)
    jh, jf = jmodel.forward_hidden(jp, jc, jnp.asarray(toks), schedule="sequential")
    th, tf = tmodel.forward_hidden(tp, tc, torch.from_numpy(toks),
                                   schedule="sequential", fused=False)
    _close(jh, th)
    ref_state = state_from_jax(jax.tree_util.tree_map(np.asarray, jf), "cpu")
    for k in ("A", "z"):
        _close(ref_state["pattern"][0][k], tf["pattern"][0][k], rtol=2e-3)


# (n_layers, S): S < L, S == L, S > L
@pytest.mark.parametrize("n_layers,S", [(4, 2), (2, 2), (2, 4)])
def test_diagonal_fused_matches_reference_full_width(arch, n_layers, S):
    """Port diagonal on the fused cell vs the reference's full-width
    diagonal driver (grouped_impl='vmap')."""
    jc, tc, jp, tp = _model(arch, n_layers if n_layers != 2 else None)
    toks = _tokens(10 + S, 2, S * jc.armt.segment_len, jc.vocab)
    jh, jf = jmodel.forward_hidden(jp, jc, jnp.asarray(toks), schedule="diagonal",
                                   grouped_impl="vmap")
    th, tf = tmodel.forward_hidden(tp, tc, torch.from_numpy(toks),
                                   schedule="diagonal", fused=True)
    assert th.shape == jh.shape
    _close(jh, th)
    _close(jf["pattern"][0]["z"], tf["pattern"][0]["z"], rtol=2e-3)
    _close(jmodel.last_logits(jp, jc, jh), tmodel.last_logits(tp, tc, th))


@pytest.mark.parametrize("n_layers,S", [(4, 3), (2, 3)])
def test_diagonal_equals_sequential_in_port(arch, n_layers, S):
    jc, tc, jp, tp = _model(arch, n_layers if n_layers != 2 else None)
    toks = torch.from_numpy(_tokens(20 + S, 2, S * tc.armt.segment_len, tc.vocab))
    sh, sf = tmodel.forward_hidden(tp, tc, toks, schedule="sequential", fused=False)
    dh, df = tmodel.forward_hidden(tp, tc, toks, schedule="diagonal", fused=True)
    oh, of = tmodel.forward_hidden(tp, tc, toks, schedule="diagonal", fused=False)
    torch.testing.assert_close(dh, sh, atol=ATOL, rtol=RTOL)
    # the per-slot oracle runs the plain block exactly as the sequential
    # executor does, only in another order: equal to the bit
    torch.testing.assert_close(oh, sh, atol=0, rtol=0)
    torch.testing.assert_close(of["pattern"][0]["A"], sf["pattern"][0]["A"],
                               atol=0, rtol=0)
    torch.testing.assert_close(df["pattern"][0]["z"], sf["pattern"][0]["z"],
                               atol=ATOL, rtol=2e-3)


@pytest.mark.parametrize("schedule", ["sequential", "diagonal"])
def test_resume_from_state_matches_reference(arch, schedule):
    """forward_hidden from a given executor state (the reference's
    init_state): the second and third segments started from the state the
    reference's sequential executor left after the first."""
    jc, tc, jp, tp = _model(arch)
    seg = jc.armt.segment_len
    toks = _tokens(31, 2, 3 * seg, jc.vocab)
    _, jf1 = jmodel.forward_hidden(jp, jc, jnp.asarray(toks[:, :seg]), schedule="sequential")
    kw = {"grouped_impl": "vmap"} if schedule == "diagonal" else {}
    jh, jf = jmodel.forward_hidden(jp, jc, jnp.asarray(toks[:, seg:]), schedule=schedule,
                                   init_state=jf1, **kw)
    th, tf = tmodel.forward_hidden(
        tp, tc, torch.from_numpy(toks[:, seg:]), schedule=schedule,
        state0=state_from_jax(jax.tree_util.tree_map(np.asarray, jf1), "cpu"))
    _close(jh, th)
    for k in ("A", "z"):
        _close(jf["pattern"][0][k], tf["pattern"][0][k], rtol=2e-3)


def test_model_module_holds_the_tree(arch):
    jc, tc, jp, tp = _model(arch)
    m = tmodel.Model(tc, tp)
    tree = m.tree()
    assert tree["pattern"][0]["attn"]["wq"] is tp["pattern"][0]["attn"]["wq"]
    assert tree["prelude"] == () and set(tree) == set(tp)
    toks = torch.from_numpy(_tokens(5, 1, tc.armt.segment_len, tc.vocab))
    h, _ = m(toks)
    want, _ = tmodel.forward_hidden(tp, tc, toks)
    torch.testing.assert_close(h, want, atol=0, rtol=0)


def test_init_params_layout_matches_reference(arch):
    jc, tc, jp, tp = _model(arch)
    mine = tmodel.init_params(tc, 0, device="cpu")
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
    assert shapes(jax.tree_util.tree_map(np.asarray, jp)) == shapes(mine)
    again = tmodel.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    torch.testing.assert_close(mine["embed"], again["embed"], atol=0, rtol=0)


@pytest.mark.parametrize("S,L", [(1, 4), (3, 3), (5, 2), (2, 7)])
def test_schedule_matches_reference(S, L):
    from repro.core import schedule as jsched
    from repro_torch.core import schedule as tsched
    groups = tsched.diagonal_groups(S, L)
    assert groups == jsched.diagonal_groups(S, L)
    assert len(groups) == tsched.n_diagonal_groups(S, L) == jsched.n_diagonal_groups(S, L)
    for i, group in enumerate(groups):
        lo, hi = tsched.band(i, S, L)
        # the band is exactly the slots (layers) of this anti-diagonal's cells
        assert sorted(l for _, l in group) == list(range(lo, hi + 1))
