"""The port's kernel layer on the CPU: each plain version against the
reference oracle (repro.kernels.ref) and against the Pallas kernel run in
interpret mode, the op entry points' layouts, the device rule, and the C
interface of the CUDA sources. The CUDA kernels themselves run only on the
card (tests/test_torch_cuda.py; chip_smoke.py holds them at full width)."""
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import armt_memory, build, flash_attention  # noqa: E402
from repro_torch.kernels import grouped_matmul, mamba_scan, ops, ref  # noqa: E402

# fp32 everywhere; the reference runs its matmuls at "highest" precision
# (tests/conftest.py), so only summation order differs
ATOL, RTOL = 5e-5, 1e-4


def _f(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(want, got, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(want, np.float32),
                               got.detach().cpu().float().numpy(),
                               atol=atol, rtol=rtol)


T_ = torch.from_numpy
J_ = jnp.asarray


# ---------------------------------------------------------------- grouped mm
@pytest.mark.parametrize("G,R,K,N,bias,act", [
    (1, 16, 16, 16, False, None),
    (3, 37, 50, 29, True, "silu"),     # ragged M/N/K, bias + silu
    (2, 48, 64, 96, True, "gelu"),     # bias + tanh-gelu
    (4, 9, 24, 8, False, "silu"),
])
def test_grouped_matmul_plain_matches_reference(G, R, K, N, bias, act):
    rng = np.random.default_rng(G * R + N)
    x, w = _f(rng, G, R, K), _f(rng, G, K, N, scale=K ** -0.5)
    b = _f(rng, G, N) if bias else None
    want = jref.grouped_matmul_ref(J_(x), J_(w), None if b is None else J_(b),
                                   activation=act)
    got = ref.grouped_matmul_ref(T_(x), T_(w), None if b is None else T_(b),
                                 activation=act)
    _close(want, got)


@pytest.mark.parametrize("G,R,K,N,act", [(3, 37, 50, 29, "silu"),
                                         (2, 24, 40, 72, "gelu")])
def test_grouped_matmul_plain_matches_pallas_interpret(G, R, K, N, act):
    rng = np.random.default_rng(R + K)
    x, w, b = _f(rng, G, R, K), _f(rng, G, K, N, scale=K ** -0.5), _f(rng, G, N)
    want = jops.grouped_gemm(J_(x), J_(w), J_(b), activation=act,
                             use_kernel=True, interpret=True)
    _close(want, ops.grouped_gemm(T_(x), T_(w), T_(b), activation=act))


def test_grouped_gemm_4d_layout_is_flattened_rows():
    rng = np.random.default_rng(3)
    x, w = T_(_f(rng, 3, 2, 7, 16)), T_(_f(rng, 3, 16, 12))
    got = ops.grouped_gemm(x, w, activation="silu")
    want = grouped_matmul.grouped_matmul_plain(x.reshape(3, 14, 16), w,
                                               activation="silu")
    assert got.shape == (3, 2, 7, 12)
    torch.testing.assert_close(got.reshape(3, 14, 12), want, rtol=0, atol=0)


# ---------------------------------------------------------------- attention
ATTN_CASES = [
    (2, 4, 2, 33, 16, True, 0),      # GQA, ragged T
    (1, 8, 1, 40, 8, True, 12),      # MQA, causal + sliding window
    (2, 2, 2, 24, 16, False, 0),     # bidirectional
    (1, 4, 4, 32, 8, False, 6),      # symmetric window
]


@pytest.mark.parametrize("N,Hq,Hkv,T,hd,causal,window", ATTN_CASES)
def test_flash_attention_plain_matches_reference(N, Hq, Hkv, T, hd, causal, window):
    rng = np.random.default_rng(T + hd)
    q, k, v = _f(rng, N, Hq, T, hd), _f(rng, N, Hkv, T, hd), _f(rng, N, Hkv, T, hd)
    want = jref.flash_attention_ref(J_(q), J_(k), J_(v), causal=causal, window=window)
    _close(want, ref.flash_attention_ref(T_(q), T_(k), T_(v), causal=causal,
                                         window=window))


@pytest.mark.parametrize("N,Hq,Hkv,T,hd,causal,window", ATTN_CASES[:2])
def test_flash_attention_plain_matches_pallas_interpret(N, Hq, Hkv, T, hd, causal,
                                                        window):
    rng = np.random.default_rng(7 * T + hd)
    q, k, v = _f(rng, N, Hq, T, hd), _f(rng, N, Hkv, T, hd), _f(rng, N, Hkv, T, hd)
    want = jops.segment_attention(J_(q), J_(k), J_(v), causal=causal, window=window,
                                  use_kernel=True, interpret=True)
    _close(want, ops.segment_attention(T_(q), T_(k), T_(v), causal=causal,
                                       window=window))


def test_segment_attention_5d_layout_matches_4d():
    rng = np.random.default_rng(5)
    G, B, T, Hq, Hkv, hd = 2, 3, 11, 4, 2, 8
    q = T_(_f(rng, G, B, T, Hq, hd))
    k, v = T_(_f(rng, G, B, T, Hkv, hd)), T_(_f(rng, G, B, T, Hkv, hd))
    got = ops.segment_attention(q, k, v, causal=True, window=5)
    flat = lambda a: a.reshape((G * B,) + a.shape[2:]).transpose(1, 2)
    want = ref.flash_attention_ref(flat(q), flat(k), flat(v), causal=True,
                                   window=5)
    torch.testing.assert_close(got, want.transpose(1, 2).reshape(got.shape),
                               rtol=0, atol=0)


# ---------------------------------------------------------------- armt memory
def _armt_inputs(seed, N, T, D, dm, Dv, M, G=None):
    rng = np.random.default_rng(seed)
    lead = (G,) if G else ()
    P = 6 * dm
    return dict(x=_f(rng, N, T, D), m=_f(rng, N, M, D),
                wq=_f(rng, *lead, D, dm, scale=0.3), wk=_f(rng, *lead, D, dm, scale=0.3),
                wv=_f(rng, *lead, D, Dv, scale=0.3), wb=_f(rng, *lead, D, 1, scale=0.3),
                A=_f(rng, N, P, Dv, scale=0.1),
                z=rng.uniform(size=(N, P)).astype(np.float32))


ARMT_CASES = [(2, 13, 24, 8, 40, 5, None),   # shared weights, odd T/Dv
              (6, 9, 32, 4, 32, 3, 2),        # per-group weights, batch 3
              (4, 16, 16, 8, 24, 8, 4)]       # per-group weights, batch 1


@pytest.mark.parametrize("N,T,D,dm,Dv,M,G", ARMT_CASES)
def test_armt_plain_matches_reference(N, T, D, dm, Dv, M, G):
    a = _armt_inputs(N * T + D, N, T, D, dm, Dv, M, G)
    j = {k: J_(v) for k, v in a.items()}
    t = {k: T_(v) for k, v in a.items()}
    _close(jref.armt_read_ref(j["x"], j["wq"], j["A"], j["z"]),
           ref.armt_read_ref(t["x"], t["wq"], t["A"], t["z"]))
    Aj, zj = jref.armt_update_ref(j["m"], j["wk"], j["wv"], j["wb"], j["A"], j["z"])
    At, zt = ref.armt_update_ref(t["m"], t["wk"], t["wv"], t["wb"], t["A"], t["z"])
    _close(Aj, At)
    _close(zj, zt)


@pytest.mark.parametrize("N,T,D,dm,Dv,M,G", ARMT_CASES[:2])
def test_armt_plain_matches_pallas_interpret(N, T, D, dm, Dv, M, G):
    a = _armt_inputs(N + T + D, N, T, D, dm, Dv, M, G)
    j = {k: J_(v) for k, v in a.items()}
    t = {k: T_(v) for k, v in a.items()}
    _close(jops.assoc_read(j["x"], j["wq"], j["A"], j["z"], use_kernel=True,
                           interpret=True),
           ops.assoc_read(t["x"], t["wq"], t["A"], t["z"]))
    Aj, zj = jops.assoc_update(j["m"], j["wk"], j["wv"], j["wb"], j["A"], j["z"],
                               use_kernel=True, interpret=True)
    At, zt = ops.assoc_update(t["m"], t["wk"], t["wv"], t["wb"], t["A"], t["z"])
    _close(Aj, At)
    _close(zj, zt)


# ------------------------------------------- fused down projection + update
# (G, R, K, N, dm, Dv, M, bias, shared wk)
FUSED_CASES = [(3, 21, 24, 16, 4, 16, 5, True, False),   # ragged rows
               (2, 40, 32, 24, 8, 24, 40, False, True),  # every row a memory row
               (4, 9, 16, 32, 4, 32, 3, False, False)]


def _fused_inputs(seed, G, R, K, N, dm, Dv, M, bias, shared):
    rng = np.random.default_rng(seed)
    P = 6 * dm
    return dict(x=_f(rng, G, R, K), w=_f(rng, G, K, N, scale=K ** -0.5),
                res=_f(rng, G, R, N),
                wk=_f(rng, *(() if shared else (G,)), N, dm, scale=0.3),
                wv=_f(rng, G, N, Dv, scale=0.3), wb=_f(rng, G, N, 1, scale=0.3),
                A=_f(rng, G, P, Dv, scale=0.1),
                z=rng.uniform(size=(G, P)).astype(np.float32),
                bias=_f(rng, G, N) if bias else None)


@pytest.mark.parametrize("G,R,K,N,dm,Dv,M,bias,shared", FUSED_CASES)
def test_grouped_matmul_armt_update_plain_matches_reference(G, R, K, N, dm, Dv, M,
                                                            bias, shared):
    """y, A' and z' of the plain version against the reference oracle and
    the Pallas kernel in interpret mode."""
    a = _fused_inputs(G * R + N, G, R, K, N, dm, Dv, M, bias, shared)
    names = ("x", "w", "res", "wk", "wv", "wb", "A", "z", "bias")
    j = [None if a[k] is None else J_(a[k]) for k in names]
    got = ref.grouped_matmul_armt_update_ref(
        *[None if a[k] is None else T_(a[k]) for k in names], M=M)
    for want in (jref.grouped_matmul_armt_update_ref(*j, M=M),
                 jops.grouped_gemm_armt_update(*j, M=M, use_kernel=True,
                                               interpret=True)):
        for w_, g_ in zip(want, got):
            _close(w_, g_)


def test_grouped_gemm_armt_update_cell_layout():
    """The [G,1,T,K] cell layout is the flattened [G,T,K] op, and the y part
    equals res + x @ w summed in fp32."""
    a = _fused_inputs(4, 2, 11, 16, 8, 4, 8, 3, True, False)
    t = {k: T_(v) for k, v in a.items()}
    before = grouped_matmul.fused_launches
    y4, A4, z4 = ops.grouped_gemm_armt_update(
        t["x"][:, None], t["w"], t["res"][:, None], t["wk"], t["wv"], t["wb"], t["A"],
        t["z"], t["bias"], M=3)
    assert grouped_matmul.fused_launches == before
    y, A2, z2 = grouped_matmul.grouped_matmul_armt_update(
        t["x"], t["w"], t["res"], t["wk"], t["wv"], t["wb"], t["A"], t["z"], t["bias"],
        M=3)
    assert y4.shape == (2, 1, 11, 8)
    for got, want in ((y4[:, 0], y), (A4, A2), (z4, z2)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(
        y, t["res"] + grouped_matmul.grouped_matmul_plain(t["x"], t["w"], t["bias"]))
    with pytest.raises(ValueError, match="batch"):
        ops.grouped_gemm_armt_update(t["x"].reshape(2, 1, 11, 16).expand(2, 2, 11, 16),
                                     t["w"], t["res"][:, None].expand(2, 2, 11, 8),
                                     t["wk"], t["wv"], t["wb"], t["A"], t["z"], M=3)


# ---------------------------------------------------------------- device rule
def test_wrappers_raise_off_cpu_and_cuda():
    """Only a CPU tensor may take the plain version; any other non-CUDA
    device is refused, not quietly computed elsewhere."""
    meta = dict(device="meta")
    x = torch.empty(2, 4, 8, **meta)
    with pytest.raises(ValueError):
        grouped_matmul.grouped_matmul(x, torch.empty(2, 8, 4, **meta))
    with pytest.raises(ValueError):
        flash_attention.flash_attention(torch.empty(1, 2, 4, 8, **meta),
                                        torch.empty(1, 2, 4, 8, **meta),
                                        torch.empty(1, 2, 4, 8, **meta))
    with pytest.raises(ValueError):
        armt_memory.armt_read(x, torch.empty(8, 2, **meta),
                              torch.empty(2, 12, 8, **meta), torch.empty(2, 12, **meta))
    with pytest.raises(ValueError):
        armt_memory.armt_update(x, *[torch.empty(8, e, **meta) for e in (2, 8, 1)],
                                torch.empty(2, 12, 8, **meta), torch.empty(2, 12, **meta))
    with pytest.raises(ValueError):
        grouped_matmul.grouped_matmul_armt_update(
            x, torch.empty(2, 8, 4, **meta), torch.empty(2, 4, 4, **meta),
            *[torch.empty(4, e, **meta) for e in (2, 4, 1)], torch.empty(2, 12, 4, **meta),
            torch.empty(2, 12, **meta), M=2)
    with pytest.raises(ValueError):
        mamba_scan.mamba_scan(x, x, torch.empty(2, 4, 4, **meta), torch.empty(2, 4, 4, **meta),
                              torch.empty(8, 4, **meta), torch.empty(8, **meta),
                              torch.empty(2, 8, 4, **meta))


def test_cpu_path_counts_no_launch():
    before = grouped_matmul.launches
    ops.grouped_gemm(torch.ones(1, 2, 3), torch.ones(1, 3, 4))
    assert grouped_matmul.launches == before
    before = mamba_scan.launches
    ops.selective_scan_fused(torch.ones(1, 2, 8), torch.ones(1, 2, 8), torch.ones(1, 2, 4),
                             torch.ones(1, 2, 4), torch.zeros(8, 4), torch.ones(8),
                             torch.zeros(1, 8, 4))
    assert mamba_scan.launches == before


def test_gemm_route_takes_tensor_cores_only_for_whole_16_byte_rows():
    """route() sends bf16 operands whose TMA rows are whole 16-byte pieces to
    the wgmma mainloop and everything else to gmm_simt; a size-1 dim's
    arbitrary stride does not matter."""
    bf, f32 = torch.bfloat16, torch.float32

    def rt(x, w, out=None):
        out = torch.empty(x.shape[0], x.shape[1], w.shape[-1], dtype=x.dtype) if out is None else out
        return grouped_matmul.route(x, w, out)
    assert rt(torch.ones(4, 37, 64, dtype=bf), torch.ones(4, 64, 40, dtype=bf)) == "wgmma"
    assert rt(torch.ones(4, 37, 64), torch.ones(4, 64, 40)) == "simt"              # fp32
    assert rt(torch.ones(2, 8, 64, dtype=bf), torch.ones(2, 64, 1, dtype=bf)) == "simt"   # N = 1
    assert rt(torch.ones(2, 8, 50, dtype=bf), torch.ones(2, 50, 64, dtype=bf)) == "simt"  # K % 8
    assert rt(torch.ones(2, 8, 0, dtype=bf), torch.ones(2, 0, 64, dtype=bf)) == "simt"    # K = 0
    base = torch.ones(3, 5, 20, 64, dtype=bf)
    assert rt(base[:, 2], torch.ones(3, 64, 16, dtype=bf)) == "wgmma"      # a batch row's view
    assert rt(base[:, 1, 4:], torch.ones(3, 64, 16, dtype=bf)) == "wgmma"  # memory rows' view
    odd = torch.ones(2, 9, 68, dtype=bf)[:, :, :64]          # 136-byte rows: not 16-byte aligned
    assert rt(odd, torch.ones(2, 64, 16, dtype=bf)) == "simt"
    shifted = torch.ones(2, 9, 72, dtype=bf)[:, :, 8:]       # 16-byte offset, 144-byte rows
    assert rt(shifted, torch.ones(2, 64, 16, dtype=bf)) == "wgmma"
    assert rt(torch.ones(2, 9, 72, dtype=bf)[:, :, 4:68], torch.ones(2, 64, 16, dtype=bf)) == "simt"
    one = torch.ones(1, 1, 64, dtype=bf).as_strided((1, 1, 64), (5, 3, 1))   # size-1 dims
    assert rt(one, torch.ones(1, 64, 8, dtype=bf)) == "wgmma"
    assert grouped_matmul._x_strides(one) == (64, 64)
    out32 = torch.empty(4, 37, 40, dtype=f32)
    assert rt(torch.ones(4, 37, 64, dtype=bf), torch.ones(4, 64, 40, dtype=bf), out32) == "wgmma"
    assert rt(torch.ones(4, 37, 64, dtype=bf), torch.ones(4, 64, 40, dtype=bf),
              torch.empty(4 * 37 * 40 + 1, dtype=f32)[1:].view(4, 37, 40)) == "simt"


def _attn(N, H, T, hd, dtype=torch.bfloat16):
    return torch.ones(N, H, T, hd, dtype=dtype)


def _cell(T, H, hd, lead=2):
    """The grouped cell's [G,B,T,H,hd] activations as a strided [N,H,T,hd] view."""
    return torch.ones(lead, 1, T, H, hd, dtype=torch.bfloat16).reshape(lead, T, H, hd
                                                                        ).transpose(1, 2)


@pytest.mark.parametrize("q,k,want", [
    (_attn(2, 8, 33, 64), _attn(2, 2, 33, 64), "wgmma"),
    (_attn(1, 4, 5, 128), _attn(1, 4, 5, 128), "wgmma"),                  # hd 128, N = 1
    (_cell(40, 8, 64), _cell(40, 2, 64), "wgmma"),                        # the cell's strided views
    (_attn(2, 8, 33, 64, torch.float32), _attn(2, 2, 33, 64, torch.float32), "simt"),
    (_attn(2, 8, 33, 40), _attn(2, 2, 33, 40), "simt"),                   # hd 40
    (_attn(2, 8, 33, 96), _attn(2, 2, 33, 96), "simt"),                   # hd 96
    (_attn(2, 8, 33, 72)[..., 8:], _attn(2, 2, 33, 64), "wgmma"),         # 144-byte rows, 16 bytes in
    (_attn(2, 8, 33, 68)[..., :64], _attn(2, 2, 33, 64), "simt"),         # 136-byte q rows
    (_attn(2, 8, 33, 72)[..., 4:68], _attn(2, 2, 33, 64), "simt"),        # q base 8 bytes off
    (_attn(2, 8, 0, 64), _attn(2, 2, 0, 64), "simt"),                     # T = S = 0
    (_attn(1, 1, 1, 64).as_strided((1, 1, 1, 64), (3, 5, 7, 1)),          # size-1 dims' strides
     _attn(1, 1, 9, 64), "wgmma"),
])
def test_flash_route_takes_tensor_cores_only_for_aligned_bf16_hd_64_or_128(q, k, want):
    """route() sends bf16 operands of head dim 64 or 128 whose bases are
    16-byte aligned and whose strides are positive multiples of 8 elements
    to the TMA + wgmma kernel and everything else to flash_simt; a size-1
    dim's arbitrary stride does not matter."""
    assert flash_attention.route(q, k, k) == want


@pytest.mark.parametrize("q,k,want", [
    (_attn(2, 32, 33, 80), _attn(2, 8, 33, 80), "wgmma"),                 # h2o-danube's hd
    (_cell(40, 32, 80), _cell(40, 8, 80), "wgmma"),                       # its cell's strided views
    (_attn(2, 8, 33, 80, torch.float32), _attn(2, 2, 33, 80, torch.float32), "simt"),
    (_attn(2, 8, 33, 84)[..., :80], _attn(2, 2, 33, 80), "simt"),         # 168-byte q rows
])
def test_flash_route_takes_tensor_cores_at_hd_80(q, k, want):
    """Head dim 80 takes the TMA + wgmma kernel under the same conditions
    as 64 and 128 (bf16, 16-byte-aligned bases, strides multiples of 8)."""
    assert 80 in flash_attention.TC_HEAD_DIMS
    assert flash_attention.route(q, k, k) == want


@pytest.mark.parametrize("q,k,want", [
    (_attn(2, 64, 33, 112), _attn(2, 8, 33, 112), "wgmma"),               # kimi-k2's heads
    (_cell(40, 64, 112), _cell(40, 8, 112), "wgmma"),                     # its cell's strided views
    (_attn(2, 8, 33, 112, torch.float32), _attn(2, 1, 33, 112, torch.float32), "simt"),
    (_attn(2, 8, 33, 116)[..., :112], _attn(2, 1, 33, 112), "simt"),      # 232-byte q rows
])
def test_flash_route_takes_tensor_cores_at_hd_112(q, k, want):
    """Head dim 112 takes the TMA + wgmma kernel under the same conditions
    as 64, 80 and 128 (bf16, 16-byte-aligned bases, strides multiples of 8)."""
    assert 112 in flash_attention.TC_HEAD_DIMS
    assert flash_attention.route(q, k, k) == want


def test_flash_strides_replace_size_one_dims():
    one = _attn(1, 1, 1, 64).as_strided((1, 1, 1, 64), (3, 5, 7, 1))
    assert flash_attention._strides(one) == (64, 64, 64)
    x = _cell(40, 8, 64)
    assert flash_attention._strides(x) == x.stride()[:3]


@pytest.mark.parametrize("S", [1, 63, 64, 65, 1100, 1152, 4096, 4097, 8192, 100_000])
def test_decode_split_plan_covers_the_cache_exactly(S):
    """The split plan is a function of S alone: chunks of whole 64-key
    tiles, at most MAX_SPLITS of them, covering [0, S) with no empty chunk."""
    from repro_torch.kernels import decode_attention as da
    chunk, n = da.split_plan(S)
    assert chunk % da.TILE == 0 and 1 <= n <= da.MAX_SPLITS
    assert (n - 1) * chunk < S <= n * chunk
    assert da.split_plan(S) == (chunk, n)
    if S <= da.TILE * da.MAX_SPLITS:
        assert chunk == da.TILE


@pytest.mark.parametrize("rep,hd,want", [
    (4, 64, (4, 1)),      # llama-1b-armt: one group, as before the split
    (4, 80, (4, 1)),      # h2o-danube-1.8b
    (5, 128, (5, 1)),     # qwen2.5-32b
    (8, 128, (8, 1)),     # chameleon-34b: 1,024 outputs, one block
    (16, 128, (8, 2)),    # chatglm3-6b: two groups of 8
    (17, 128, (6, 3)),    # uneven: 6 + 6 + 5
    (64, 16, (64, 1)),
])
def test_decode_head_groups_fit_a_block(rep, hd, want):
    """The q heads of a kv head are cut into the fewest groups whose
    outputs one block holds (heads * hd <= MAX_GROUP_WIDTH), covering every
    head, none empty."""
    from repro_torch.kernels import decode_attention as da
    per, n = da.head_groups(rep, hd)
    assert (per, n) == want
    assert per * hd <= da.MAX_GROUP_WIDTH and (n - 1) * per < rep <= n * per


# ---------------------------------------------------------------- C interface
_CTYPE_ARG = re.compile(r"\b(const\s+void\s*\*|void\s*\*|int|long\s+long|float)\s+\w+")


def test_c_entry_points_match_ctypes_signatures():
    """Every extern "C" launcher in csrc/ has the argument count and kinds
    the ctypes bindings declare, and every binding has a launcher."""
    found = {}
    for cu in build.CSRC.glob("*.cu"):
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                     cu.read_text()):
            kinds = []
            for a in args.split(","):
                kind = _CTYPE_ARG.search(" ".join(a.split())).group(1)
                kinds.append("p" if "*" in kind else
                             {"int": "i", "float": "f"}.get(kind, "l"))
            found[name] = kinds
    import ctypes
    code = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_longlong: "l",
            ctypes.c_float: "f"}
    assert set(found) == set(build.SIGNATURES)
    assert {"mamba_scan_launch", "decode_attention_launch", "gmm_launch",
            "flash_attention_launch"} <= set(found)
    for name, argtypes in build.SIGNATURES.items():
        assert found[name] == [code[a] for a in argtypes], name


def test_source_hash_tracks_sources():
    h = build.source_hash()
    assert h == build.source_hash() and len(h) == 16
    assert build.BUILD_ROOT.name == "kernels" and build.BUILD_ROOT.parent.name == "build"


def test_swap_replaces_ops_entries_inside_the_block_only():
    """kernels/swap: the checks on the card replace ops entry points for a
    block (negative controls, the plain versions as a second rounding) and
    must leave the module as it was, also when the block raises."""
    from repro_torch.kernels import swap
    before = {k: getattr(ops, k) for k in swap.PLAIN}
    assert set(swap.PLAIN) <= set(vars(ops))
    with pytest.raises(RuntimeError):
        with swap.plain_versions():
            assert all(getattr(ops, k) is v for k, v in swap.PLAIN.items())
            raise RuntimeError
    assert {k: getattr(ops, k) for k in swap.PLAIN} == before
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 5, 8)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 8, 3)).astype(np.float32))
    with swap.replaced(grouped_matmul=lambda x, w, *a, **k: 2 * torch.matmul(x, w)):
        torch.testing.assert_close(ops.grouped_gemm(x, w), 2 * torch.matmul(x, w))
    torch.testing.assert_close(ops.grouped_gemm(x, w), torch.matmul(x, w))
