"""The port's Mamba layer against the JAX reference at smoke size (fp32,
CPU): the selective scan's plain version against the reference's oracle and
its Pallas kernel in interpret mode (one layer, and a band of layers in the
grouped ``[G, B, ...]`` layout), the causal conv with its carried tail, and
the mixer over segments with carried state against both of the reference's
scan methods. Inputs come from numpy seeds."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import SSMConfig as JSSM  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro_torch.configs import SSMConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import mamba_scan as tscan  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402

# fp32 on both sides, summation order only
RTOL, ATOL = 1e-4, 5e-5


def _close(want, got, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().cpu().float().numpy(), rtol=rtol, atol=atol)


def _scan_inputs(seed, lead, T, dI, dS, groups=()):
    """x, dt, B, C [*lead, T, .], A_log/D [*groups, dI(, dS)], h0 [*lead,
    dI, dS]; dt is softplus of a normal, A = -[1..dS] jittered."""
    rng = np.random.default_rng(seed)

    def f(*s, sc=1.0):
        return (rng.standard_normal(s) * sc).astype(np.float32)
    x = f(*lead, T, dI, sc=0.5)
    dt = np.log1p(np.exp(f(*lead, T, dI))).astype(np.float32)
    Bt, Ct = f(*lead, T, dS, sc=0.5), f(*lead, T, dS, sc=0.5)
    A_log = np.log(np.arange(1, dS + 1, dtype=np.float32)
                   * rng.uniform(0.5, 1.5, (*groups, dI, dS))).astype(np.float32)
    D = f(*groups, dI)
    h0 = f(*lead, dI, dS, sc=0.1)
    return x, dt, Bt, Ct, A_log, D, h0


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


# the shapes of the reference's own kernel test (tests/test_kernels.py)
@pytest.mark.parametrize("B,T,dI,dS", [(1, 8, 16, 4), (2, 16, 24, 4), (2, 32, 64, 8)])
def test_scan_plain_matches_reference_and_pallas_interpret(B, T, dI, dS):
    args = _scan_inputs(B * T + dI, (B,), T, dI, dS)
    y, hT = ref.mamba_scan_ref(*_t(*args))
    jargs = [jnp.asarray(a) for a in args]
    for want_y, want_h in (jref.mamba_scan_ref(*jargs),
                           jops.selective_scan_fused(*jargs, use_kernel=True,
                                                     interpret=True)):
        _close(want_y, y)
        _close(want_h, hT)
    # the ops entry point takes the plain version on the CPU: no launch
    before = tscan.launches
    y2, h2 = ops.selective_scan_fused(*_t(*args))
    assert tscan.launches == before
    torch.testing.assert_close(y2, y, rtol=0, atol=0)
    torch.testing.assert_close(h2, hT, rtol=0, atol=0)


@pytest.mark.parametrize("G,B,T,dI,dS", [(3, 2, 20, 24, 4), (2, 1, 9, 16, 8)])
def test_grouped_band_layout_matches_per_group_reference(G, B, T, dI, dS):
    """The band layout [G, B, ...] with per-group A_log [G, dI, dS] and D
    [G, dI] (one launch on the card) against one reference call per group."""
    x, dt, Bt, Ct, A_log, D, h0 = _scan_inputs(G + T, (G, B), T, dI, dS, groups=(G,))
    y, hT = ops.selective_scan_fused(*_t(x, dt, Bt, Ct, A_log, D, h0))
    assert y.shape == (G, B, T, dI) and hT.shape == (G, B, dI, dS)
    for g in range(G):
        wy, wh = jops.selective_scan_fused(
            *[jnp.asarray(a[g]) for a in (x, dt, Bt, Ct, A_log, D, h0)],
            use_kernel=True, interpret=True)
        _close(wy, y[g])
        _close(wh, hT[g])


def test_scan_takes_strided_b_c_and_t_zero():
    """B and C as column slices of one x_proj output (what the model passes),
    and an empty sequence, which returns h0."""
    x, dt, _, _, A_log, D, h0 = _scan_inputs(5, (2,), 11, 16, 4)
    proj = np.random.default_rng(6).standard_normal((2, 11, 3 + 8)).astype(np.float32)
    Bs, Cs = torch.from_numpy(proj)[..., 3:7], torch.from_numpy(proj)[..., 7:]
    y, hT = ops.selective_scan_fused(*_t(x, dt), Bs, Cs, *_t(A_log, D, h0))
    wy, wh = jref.mamba_scan_ref(*[jnp.asarray(a) for a in
                                   (x, dt, proj[..., 3:7], proj[..., 7:], A_log, D, h0)])
    _close(wy, y)
    _close(wh, hT)
    y0, h00 = ref.mamba_scan_ref(*_t(x[:, :0], dt[:, :0]), Bs[:, :0], Cs[:, :0],
                                 *_t(A_log, D, h0))
    assert y0.shape == (2, 0, 16)
    torch.testing.assert_close(h00, torch.from_numpy(h0), rtol=0, atol=0)


@pytest.mark.parametrize("T", [1, 2, 4, 9])
def test_causal_conv_matches_reference(T):
    rng = np.random.default_rng(T)
    dc, dI = 4, 12
    xi = rng.standard_normal((2, T, dI)).astype(np.float32)
    tail = rng.standard_normal((2, dc - 1, dI)).astype(np.float32)
    w = rng.standard_normal((dc, dI)).astype(np.float32)
    b = rng.standard_normal(dI).astype(np.float32)
    wy, wtail = jmamba._causal_conv(*[jnp.asarray(a) for a in (xi, tail, w, b)])
    y, new_tail = tmamba._causal_conv(*_t(xi, tail, w, b))
    _close(wy, y)
    _close(wtail, new_tail)


def _mixer_params(seed, D, scfg):
    jp = jmamba.mamba_param_init(jax.random.PRNGKey(seed), D, JSSM(**vars(scfg)),
                                 jnp.float32)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("method", ["scan", "assoc"])
def test_mixer_over_segments_matches_reference(method):
    """Three segments with the state (h, conv tail) carried between them."""
    scfg, D, B = SSMConfig(d_state=4, d_conv=4, expand=2), 16, 2
    jp, tp = _mixer_params(0, D, scfg)
    jst = jmamba.mamba_state_init(B, D, JSSM(**vars(scfg)), jnp.float32)
    tst = tmamba.mamba_state_init(B, D, scfg, torch.float32, "cpu")
    x = np.random.default_rng(1).standard_normal((B, 3 * 12, D)).astype(np.float32)
    for s in range(3):
        seg = x[:, s * 12:(s + 1) * 12]
        wy, jst = jmamba.mamba_mixer(jnp.asarray(seg), jp, JSSM(**vars(scfg)), jst,
                                     method=method)
        y, tst = tmamba.mamba_mixer(torch.from_numpy(seg), tp, scfg, tst)
        _close(wy, y)
        _close(jst["h"], tst["h"])
        _close(jst["conv"], tst["conv"])


def test_decode_step_token_by_token_equals_the_segment():
    """mamba_decode_step, one token at a time with the state carried, gives
    the mixer's output over the whole segment (the reference's own check)."""
    scfg, D = SSMConfig(d_state=4, d_conv=4, expand=2), 8
    _, tp = _mixer_params(0, D, scfg)
    st = tmamba.mamba_state_init(1, D, scfg, torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 6, D)).astype(np.float32))
    y_seg, st_seg = tmamba.mamba_mixer(x, tp, scfg, st)
    ys = []
    for t in range(6):
        y_t, st = tmamba.mamba_decode_step(x[:, t:t + 1], tp, scfg, st)
        ys.append(y_t)
    torch.testing.assert_close(torch.cat(ys, 1), y_seg, rtol=RTOL, atol=ATOL)
    for k in ("h", "conv"):
        torch.testing.assert_close(st[k], st_seg[k], rtol=RTOL, atol=ATOL)


def test_mixer_band_layout_equals_per_layer_mixer():
    """The grouped band layout (stacked weights [G, ...], state [G, B, ...])
    computes each layer's mixer: the projections as one batched matmul, the
    scan as one call over G*B rows."""
    scfg, D, B, G = SSMConfig(d_state=4, d_conv=4, expand=2), 16, 2, 3
    layers = [_mixer_params(g, D, scfg)[1] for g in range(G)]
    stacked = {k: torch.stack([p[k] for p in layers]) for k in layers[0]}
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((G, B, 7, D)).astype(np.float32))
    st = {"h": torch.from_numpy(rng.standard_normal((G, B, 2 * D, 4)).astype(np.float32)),
          "conv": torch.from_numpy(rng.standard_normal((G, B, 3, 2 * D)).astype(np.float32))}
    y, new = tmamba.mamba_mixer(x, stacked, scfg, st)
    for g in range(G):
        yg, ng = tmamba.mamba_mixer(x[g], layers[g], scfg, {k: v[g] for k, v in st.items()})
        torch.testing.assert_close(y[g], yg, rtol=RTOL, atol=ATOL)
        for k in ("h", "conv"):
            torch.testing.assert_close(new[k][g], ng[k], rtol=RTOL, atol=ATOL)


def test_mamba_dims_match_reference():
    for D, scfg in [(4096, SSMConfig(d_state=16)), (32, SSMConfig(d_state=4)),
                    (100, SSMConfig(dt_rank=7, expand=3))]:
        assert tmamba.mamba_dims(D, scfg) == jmamba.mamba_dims(D, JSSM(**vars(scfg)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_with_dt_prologue_and_gate_matches_reference_composition(dtype):
    """The scan with the mixer's dt softplus and output gate taken in
    (``dt_bias=``, ``z=``; on the CPU the plain version), in the band layout
    [G, B, ...], against the reference's composition for each group:
    softplus(dt + dt_bias) in fp32, the Pallas ``mamba_scan`` in interpret
    mode (its D skip included), then ``y.astype(dtype) * silu(z)``. fp32:
    summation order only (RTOL, ATOL). bf16: the same fp32 y rounds through
    the same ops, but the two frameworks' silu formulas may round z's gate
    one bf16 step apart, so y is held to 1e-2 relative; hT is fp32 on both
    sides."""
    G, B, T, dI, dS = 2, 2, 13, 24, 4
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x, _, Bt, Ct, A_log, D, h0 = _scan_inputs(11, (G, B), T, dI, dS, groups=(G,))
    rng = np.random.default_rng(12)
    raw = rng.standard_normal((G, B, T, dI)).astype(np.float32)
    bias = (rng.uniform(-5.0, -3.0, (G, dI))).astype(np.float32)
    z = rng.standard_normal((G, B, T, dI)).astype(np.float32)
    # the activations in the model dtype, the same values on both sides
    x, raw, z = (np.array(jnp.asarray(a, jdt).astype(jnp.float32)) for a in (x, raw, z))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tx, traw, tz = (torch.from_numpy(a).to(tdt) for a in (x, raw, z))
    before = tscan.launches
    y, hT = ops.selective_scan_fused(tx, traw, *_t(Bt, Ct, A_log, D, h0),
                                     dt_bias=torch.from_numpy(bias), z=tz)
    assert tscan.launches == before and y.dtype == tdt and y.shape == (G, B, T, dI)
    for g in range(G):
        dt = jax.nn.softplus(jnp.asarray(raw[g], jdt).astype(jnp.float32) + bias[g])
        wy, wh = jops.selective_scan_fused(
            jnp.asarray(x[g], jdt), dt, *[jnp.asarray(a[g]) for a in (Bt, Ct, A_log, D, h0)],
            use_kernel=True, interpret=True)
        wy = wy.astype(jdt) * jax.nn.silu(jnp.asarray(z[g], jdt))
        if dtype == "float32":
            _close(wy, y[g])
        else:
            _close(np.asarray(wy.astype(jnp.float32)), y[g].float(), rtol=1e-2, atol=1e-2)
        _close(wh, hT[g])


@pytest.mark.parametrize("given", ["dt_bias", "z"])
def test_scan_refuses_half_of_the_fused_form(given):
    """``dt_bias=`` and ``z=`` make one form (raw dt in, gated y out): a call
    with only one of them is refused, on the CPU as on the card."""
    B, T, dI, dS = 2, 5, 8, 4
    x, dt, Bt, Ct, A_log, D, h0 = _t(*_scan_inputs(3, (B,), T, dI, dS))
    kw = {"dt_bias": torch.zeros(dI)} if given == "dt_bias" else {"z": torch.zeros_like(x)}
    with pytest.raises(ValueError, match="go together"):
        tscan.mamba_scan(x, dt, Bt, Ct, A_log, D, h0, **kw)
