"""The port's CUDA kernels against their plain versions on the card, at
small odd shapes: ragged rows and columns on the tensor-core paths (the
GEMM's TMA + wgmma route: ragged R, K and N, strided x rows and res, weight
batches, more tiles than SMs), ragged cache lengths and windows for decode
attention, ragged channels, strided B/C, grouped A_log/D and T = 1 for the
Mamba scan, the scan's dt prologue and gate epilogue on strided raw dt and
z, 256-channel and small blocks giving the same bits, and the fp32
paths; armt_read's split three-term bf16 product at ragged T and Dv; the
flash kernel's TMA + wgmma route at
ragged T, hd 64, 80 and 128, windows and the cell's strided 5-D layout; the
split decode kernel at chunk edges and at 16 q heads per kv head, and a row
batched or alone giving the same bits; the QKV bias with a layer index;
the long shapes of the full-attention and full-KV paths (flash
at T = S = 16,384 and 131,072, decode over 131,136 keys), the cache-mode
prefill against full mode and sampling on the device; and the captured
programs (llama's generate, greedy and sampled, and serve; cache-mode
generate; falcon's generate and serve; the sequential schedule's segment)
against the same programs run
eagerly, to the bit, with equal launch counts, and a failed capture
raising; jamba's fused cells on a strided band against the plain block,
its diagonal schedule's strided bands against the sequential one to the
bit, and the blockwise cell FFN (cell_block) on the attn cell; whisper's
shapes (flash without a mask at T != S over 1,500 keys read from a cross
K/V buffer, decode's cross-attention at rep 1 x hd 64), its fused dec cell
against the plain block, and its forward and generate at full width (the
encoder, diagonal = sequential, graphs = eager, graphs that follow each
request's frames); the training kernels' autograd Functions against
autograd through their plain versions, and the training path at a
reduced width (kernel gradients against the plain path, diagonal =
sequential, no SIMT, the unfused B = 1 route against the fused op). Needs a CUDA device and nvcc; skips without a card. This file
imports no JAX; with ``--noconftest`` (tests/conftest.py imports JAX) it
runs on a machine that has only PyTorch:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import (armt_memory, flash_attention, grouped_matmul,  # noqa: E402
                                 mamba_scan)

# Per-row relative L2 error: bf16 output rounding reads ~1e-3; fp32 is at
# summation-order level. A/z state is fp32 on every path.
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _f32(*ts):
    """The plain versions run in fp32 on the same input values, so a check
    measures only the kernel's rounding."""
    return [t.float() for t in ts]


def _close(got, want, tol):
    """Every row (last dim) within tol of its own norm, so rows of small
    values are held as tightly as the largest ones."""
    got, want = got.float(), want.float()
    row = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    assert torch.isfinite(got).all() and row.max().item() <= tol, row.max().item()


def _rand(g, dev, dtype):
    return lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,R,K,N,act", [(3, 37, 48, 40, "silu"),   # mma path in bf16
                                         (2, 130, 64, 136, "gelu"),
                                         (16, 1100, 72, 512, None),  # ragged rows and K
                                         (3, 37, 50, 29, None)])    # no 16-byte rows
def test_grouped_matmul_on_card(cuda, dtype, G, R, K, N, act):
    r = _rand(torch.Generator().manual_seed(R), cuda, dtype)
    x, w, b = r(G, R, K), r(G, K, N, sc=K ** -0.5), r(G, N)
    _close(grouped_matmul.grouped_matmul(x, w, b, activation=act),
           grouped_matmul.grouped_matmul_plain(*_f32(x, w, b), activation=act), TOL[dtype])


def _tc_launch(fn):
    """fn's result, checking that it made exactly one GEMM launch, on the
    TMA + wgmma route."""
    tc, simt = grouped_matmul.tc_launches, grouped_matmul.simt_launches
    out = fn()
    torch.cuda.synchronize()
    assert (grouped_matmul.tc_launches - tc, grouped_matmul.simt_launches - simt) == (1, 0)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("G,R,K,N,act", [
    (2, 40, 64, 128, None),        # R < 64: the second warpgroup's rows all past R
    (4, 1100, 128, 256, "silu"),   # ragged rows over 9 row tiles
    (3, 130, 72, 136, "gelu"),     # K = 72: a zero-filled K tail; N = 136: ragged BN
    (2, 200, 8192, 256, None),     # K = 8192: 128 K stages through the ring
    (2, 70, 64, 40, None),         # N = 40 < one 64-column TMA box
    (3, 129, 96, 64, "silu"),      # N = 64: 128-column tiles, half zero-filled
    (1, 4096, 256, 2048, None),    # G = 1, 256 tiles: more than one per SM
])
def test_grouped_matmul_tc_shapes_on_card(cuda, G, R, K, N, act):
    r = _rand(torch.Generator().manual_seed(R + K + N), cuda, torch.bfloat16)
    x, w, b = r(G, R, K), r(G, K, N, sc=K ** -0.5), r(G, N)
    out = _tc_launch(lambda: grouped_matmul.grouped_matmul(x, w, b, activation=act))
    _close(out, grouped_matmul.grouped_matmul_plain(*_f32(x, w, b), activation=act), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["batch_slice", "memory_rows"])
def test_grouped_matmul_strided_rows_on_card(cuda, view):
    """x read through its strides, as the cell passes it: one batch row of a
    [G, B, T, K] tensor, and the memory rows y[:, R - M:] of a [G, R, K]."""
    r = _rand(torch.Generator().manual_seed(7), cuda, torch.bfloat16)
    G, K, N = 3, 96, 136
    if view == "batch_slice":
        x = r(G, 3, 150, K)[:, 1]
    else:
        x = r(G, 300, K)[:, 300 - 128:]
    assert not x.is_contiguous()
    w = r(G, K, N, sc=K ** -0.5)
    out = _tc_launch(lambda: grouped_matmul.grouped_matmul(x, w))
    _close(out, grouped_matmul.grouped_matmul_plain(*_f32(x, w)), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("G,batch,R,K,N", [(2, 3, 128, 256, 64), (4, 2, 37, 64, 2048)])
def test_project_f32_weight_batch_on_card(cuda, G, batch, R, K, N):
    """wbatch > 1 with an fp32 epilogue, as the ARMT kernels project: row n
    of x uses weight group n // batch, and bf16 x bf16 products are exact in
    fp32, so the result is held at the fp32 tolerance."""
    r = _rand(torch.Generator().manual_seed(R + N), cuda, torch.bfloat16)
    x, w = r(G * batch, R, K), r(G, K, N, sc=K ** -0.5)
    out = _tc_launch(lambda: grouped_matmul.project_f32(x, w, batch))
    assert out.dtype == torch.float32
    want = torch.matmul(x.float(), w.float().repeat_interleave(batch, 0))
    _close(out, want, 1e-4)


@pytest.mark.cuda
def test_grouped_matmul_residual_row_stride_on_card(cuda):
    """res read through a row stride other than N, added to the fp32
    accumulator before the one cast."""
    r = _rand(torch.Generator().manual_seed(3), cuda, torch.bfloat16)
    G, R, K, N = 2, 200, 128, 256
    x, w = r(G, R, K), r(G, K, N, sc=K ** -0.5)
    res = r(G, R, N + 24)[:, :, 5:5 + N]
    assert res.stride(1) == N + 24
    out = torch.empty(G, R, N, dtype=torch.bfloat16, device=cuda)
    _tc_launch(lambda: grouped_matmul.launch(x, w, None, out, res=res))
    _close(out, res.float() + grouped_matmul.grouped_matmul_plain(*_f32(x, w)), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Hq,Hkv,T,hd,causal,window", [
    (2, 4, 2, 100, 64, True, 0),     # mma path in bf16, ragged T
    (1, 4, 1, 150, 64, True, 37),    # sliding window
    (2, 4, 2, 33, 40, True, 9),      # head dim 40
    (1, 2, 2, 70, 64, False, 20),    # symmetric window
])
def test_flash_attention_on_card(cuda, dtype, N, Hq, Hkv, T, hd, causal, window):
    r = _rand(torch.Generator().manual_seed(T), cuda, dtype)
    q, k, v = r(N, Hq, T, hd), r(N, Hkv, T, hd), r(N, Hkv, T, hd)
    _close(flash_attention.flash_attention(q, k, v, causal=causal, window=window),
           flash_attention.flash_attention_plain(*_f32(q, k, v), causal=causal,
                                                 window=window),
           TOL[dtype])


def _flash_tc(fn):
    """fn's result, checking that it made exactly one flash launch, on the
    TMA + wgmma route."""
    tc, simt = flash_attention.tc_launches, flash_attention.simt_launches
    out = fn()
    torch.cuda.synchronize()
    assert (flash_attention.tc_launches - tc, flash_attention.simt_launches - simt) == (1, 0)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("N,Hq,Hkv,T,hd,causal,window", [
    (1, 4, 1, 1, 64, True, 0),        # one row: 127 rows of the tile past T
    (2, 4, 1, 65, 64, True, 0),       # MQA, rep 4, ragged T
    (1, 4, 4, 127, 128, True, 0),     # hd 128, rep 1
    (2, 8, 2, 129, 64, True, 0),      # two query tiles, the second of one row
    (1, 8, 2, 1100, 128, True, 0),    # hd 128 over 18 key tiles, N = 1
    (1, 4, 1, 1100, 64, True, 300),   # a causal window starting mid-tile
    (2, 4, 4, 300, 64, True, 77),     # windows narrower than a tile
    (1, 4, 2, 200, 128, False, 50),   # a non-causal window
    (1, 2, 2, 150, 64, False, 0),     # bidirectional
])
def test_flash_attention_tc_on_card(cuda, N, Hq, Hkv, T, hd, causal, window):
    r = _rand(torch.Generator().manual_seed(T + hd + window), cuda, torch.bfloat16)
    q, k, v = r(N, Hq, T, hd), r(N, Hkv, T, hd), r(N, Hkv, T, hd)
    assert flash_attention.route(q, k, v) == "wgmma"
    out = _flash_tc(lambda: flash_attention.flash_attention(q, k, v, causal=causal,
                                                            window=window))
    _close(out, flash_attention.flash_attention_plain(*_f32(q, k, v), causal=causal,
                                                      window=window), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("N,Hq,Hkv,T,hd,causal,window", [
    (1, 4, 1, 1, 80, True, 0),        # one row
    (2, 8, 2, 129, 80, True, 0),      # two query tiles, the second of one row
    (1, 32, 8, 1100, 80, True, 0),    # h2o-danube's heads over 18 key tiles
    (1, 4, 1, 1100, 80, True, 300),   # a causal window starting mid-tile
    (1, 4, 2, 200, 80, False, 50),    # a non-causal window
])
def test_flash_attention_tc_hd_80_on_card(cuda, N, Hq, Hkv, T, hd, causal, window):
    """Head dim 80 (h2o-danube-1.8b) on the TMA + wgmma kernel: hd 128's
    tile layout with the last 48 columns zero-filled on chip."""
    r = _rand(torch.Generator().manual_seed(T + window + 80), cuda, torch.bfloat16)
    q, k, v = r(N, Hq, T, hd), r(N, Hkv, T, hd), r(N, Hkv, T, hd)
    assert flash_attention.route(q, k, v) == "wgmma"
    out = _flash_tc(lambda: flash_attention.flash_attention(q, k, v, causal=causal,
                                                            window=window))
    _close(out, flash_attention.flash_attention_plain(*_f32(q, k, v), causal=causal,
                                                      window=window), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,Hq,Hkv,T,causal,window", [
    (1, 8, 1, 1, True, 0),          # one row
    (2, 8, 1, 129, True, 0),        # two query tiles, the second of one row
    (1, 64, 8, 1100, True, 0),      # kimi-k2's heads over 18 key tiles
    (1, 8, 1, 1100, True, 300),     # a causal window starting mid-tile
    (1, 8, 2, 200, False, 50),      # a non-causal window
])
def test_flash_attention_hd_112_on_card(cuda, dtype, N, Hq, Hkv, T, causal, window):
    """Head dim 112 (kimi-k2-1t-a32b): bf16 on the TMA + wgmma kernel (hd
    128's tile layout, the last 16 columns zero-filled on chip), fp32 on
    flash_simt, each against its plain version."""
    r = _rand(torch.Generator().manual_seed(T + window + 112), cuda, dtype)
    q, k, v = r(N, Hq, T, 112), r(N, Hkv, T, 112), r(N, Hkv, T, 112)
    assert flash_attention.route(q, k, v) == ("wgmma" if dtype == torch.bfloat16 else "simt")
    run = lambda: flash_attention.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                                  window=window)
    out = _flash_tc(run) if dtype == torch.bfloat16 else run()
    _close(out, flash_attention.flash_attention_plain(*_f32(q, k, v), causal=causal,
                                                      window=window), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("G,B,T,Hq,Hkv,hd", [
    (16, 1, 1152, 32, 8, 64),    # llama-1b-armt's full band step, the main shape
    (4, 2, 1152, 24, 8, 128),    # llama-3b-armt's heads, two batch rows
    (4, 1, 1152, 32, 8, 80),     # h2o-danube-1.8b's heads
    (2, 1, 1152, 64, 8, 112),    # kimi-k2-1t-a32b's heads
])
def test_flash_attention_cell_layout_on_card(cuda, G, B, T, Hq, Hkv, hd):
    """The grouped cell's [G,B,T,H,hd] activations through
    ops.segment_attention: strided [N,H,T,hd] views, read by the TMA."""
    from repro_torch.kernels import ops
    r = _rand(torch.Generator().manual_seed(G + hd), cuda, torch.bfloat16)
    q, k, v = r(G, B, T, Hq, hd), r(G, B, T, Hkv, hd), r(G, B, T, Hkv, hd)

    def flat(a):
        return a.reshape((G * B,) + a.shape[2:]).transpose(1, 2)
    assert flash_attention.route(flat(q), flat(k), flat(v)) == "wgmma"
    out = _flash_tc(lambda: ops.segment_attention(q, k, v, causal=True))
    want = flash_attention.flash_attention_plain(*_f32(flat(q), flat(k), flat(v)))
    _close(out, want.transpose(1, 2).reshape(out.shape), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_armt_memory_on_card(cuda, dtype):
    g = torch.Generator().manual_seed(0)
    r = _rand(g, cuda, dtype)
    A = (torch.randn(4, 48, 40, generator=g) * 0.1).to(cuda)
    z = torch.rand(4, 48, generator=g).to(cuda)
    xr, wq = r(4, 13, 24), r(2, 24, 8, sc=0.3)
    _close(armt_memory.armt_read(xr, wq, A, z),
           armt_memory.armt_read_plain(*_f32(xr, wq), A, z), TOL[dtype])
    m, wk, wv, wb = r(4, 5, 24), r(2, 24, 8, sc=0.3), r(2, 24, 40, sc=0.3), r(2, 24, 1)
    for got, want in zip(armt_memory.armt_update(m, wk, wv, wb, A, z),
                         armt_memory.armt_update_plain(*_f32(m, wk, wv, wb), A, z)):
        _close(got, want, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S,hd,lens,window", [
    (4, 32, 8, 1152, 64, (1024, 517, 1, 1152), 0),   # main path: rep 4, lengths 1 and S
    (3, 4, 4, 77, 64, (77, 40, 1), 0),               # rep 1, ragged cache length
    (2, 8, 2, 100, 40, (100, 63), 17),               # hd 40, sliding window
    (2, 4, 1, 33, 128, (33, 5), 9),                  # MQA, hd 128, window past the start
    (4, 64, 8, 1152, 112, (1152, 517, 1, 1025), 0),  # kimi-k2: rep 8, hd 112, ARMT cache
    (4, 16, 16, 2112, 128, (2049, 2064, 1, 1500), 0),  # qwen2-moe: rep 1, cache mode
])
def test_decode_attention_on_card(cuda, dtype, B, Hq, Hkv, S, hd, lens, window):
    from repro_torch.kernels import decode_attention as da
    r = _rand(torch.Generator().manual_seed(S + hd), cuda, dtype)
    q = r(B, Hq, hd)
    cache = r(B, S, 2 * Hkv, hd)               # k and v interleaved: strided views
    k, v = cache[:, :, :Hkv], cache[:, :, Hkv:]
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    _close(da.decode_attention(q, k, v, lengths, window=window),
           da.decode_attention_plain(*_f32(q, k, v), lengths, window=window), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S,hd,lens,window", [
    (4, 32, 8, 1152, 64, (1, 63, 64, 65), 0),        # lengths at the 64-key chunk edges
    (4, 32, 8, 1152, 64, (1152, 1000, 129, 700), 40),  # windows in one chunk and across two
    (2, 32, 8, 1100, 64, (1100, 1099), 200),         # S not a multiple of the chunk
    (3, 8, 2, 1100, 128, (1100, 5, 640), 2000),      # windows >= the length
    (1, 4, 1, 300, 64, (300,), 0),                   # B = 1, one kv head
])
def test_decode_attention_split_on_card(cuda, dtype, B, Hq, Hkv, S, hd, lens, window):
    from repro_torch.kernels import decode_attention as da
    r = _rand(torch.Generator().manual_seed(S + sum(lens)), cuda, dtype)
    q, k, v = r(B, Hq, hd), r(B, S, Hkv, hd), r(B, S, Hkv, hd)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = da.launches
    out = da.decode_attention(q, k, v, lengths, window=window)
    assert da.launches == before + 1   # partials and combine count as one
    _close(out, da.decode_attention_plain(*_f32(q, k, v), lengths, window=window), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,lens,window", [
    (1152, (1152, 517, 1, 1000), 0),      # chatglm3-6b's ARMT decode cache
    (4100, (4100, 64, 65, 2000), 1000),   # a window across chunks
])
def test_decode_attention_rep_16_on_card(cuda, dtype, S, lens, window):
    """chatglm3-6b's grouping, 32 q heads over 2 kv heads of 128 dims: each
    kv head's 16 q heads in two blocks of 8, against the plain version; a
    row batched with 3 others equals, bit for bit, the row alone."""
    from repro_torch.kernels import decode_attention as da
    assert da.head_groups(16, 128) == (8, 2)
    r = _rand(torch.Generator().manual_seed(S + 16), cuda, dtype)
    q, k, v = r(4, 32, 128), r(4, S, 2, 128), r(4, S, 2, 128)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = da.decode_attention(q, k, v, lengths, window=window)
    _close(out, da.decode_attention_plain(*_f32(q, k, v), lengths, window=window), TOL[dtype])
    for b in range(4):
        alone = da.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], lengths[b:b + 1],
                                    window=window)
        assert torch.equal(out[b], alone[0]), b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,hd,S,lens", [
    (64, 8, 112, 1152, (1152, 517, 1, 1025)),    # kimi-k2's ARMT decode cache
    (64, 8, 112, 2112, (2049, 2064, 1, 1500)),   # kimi-k2's cache mode
    (16, 16, 128, 1152, (1152, 517, 1, 1025)),   # qwen2-moe's ARMT decode cache
    (16, 16, 128, 2112, (2049, 2064, 1, 1500)),  # qwen2-moe's cache mode
])
def test_decode_attention_moe_heads_on_card(cuda, dtype, Hq, Hkv, hd, S, lens):
    """The MoE configs' decode heads, rep 8 at hd 112 (one head group of
    896 outputs) and rep 1 at hd 128, on contiguous caches as the model
    holds them: against the plain version, and a row batched with 3 others
    equal, to the bit, to the row alone."""
    from repro_torch.kernels import decode_attention as da
    r = _rand(torch.Generator().manual_seed(S + hd), cuda, dtype)
    q, k, v = r(4, Hq, hd), r(4, S, Hkv, hd), r(4, S, Hkv, hd)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = da.decode_attention(q, k, v, lengths)
    _close(out, da.decode_attention_plain(*_f32(q, k, v), lengths), TOL[dtype])
    for b in range(4):
        alone = da.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], lengths[b:b + 1])
        assert torch.equal(out[b], alone[0]), b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_row_is_batch_independent_on_card(cuda, dtype):
    """The split depends on S alone, so a row computed in a batch of 4
    equals, bit for bit, the same row computed alone."""
    from repro_torch.kernels import decode_attention as da
    r = _rand(torch.Generator().manual_seed(11), cuda, dtype)
    q, k, v = r(4, 32, 64), r(4, 1152, 8, 64), r(4, 1152, 8, 64)
    lengths = torch.tensor((1152, 517, 1, 1000), dtype=torch.int32, device=cuda)
    for window in (0, 300):
        batched = da.decode_attention(q, k, v, lengths, window=window)
        for b in range(4):
            alone = da.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                        lengths[b:b + 1], window=window)
            assert torch.equal(batched[b], alone[0]), (
                window, b, (batched[b].float() - alone[0].float()).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,R,K,N,M,bias", [(3, 37, 48, 40, 5, True),     # mma path in bf16
                                            (2, 130, 72, 56, 128, False),  # rows past a 128-row tile
                                            (2, 21, 50, 24, 7, False)])    # ragged K
def test_grouped_matmul_armt_update_on_card(cuda, dtype, G, R, K, N, M, bias):
    g = torch.Generator().manual_seed(R + K)
    r = _rand(g, cuda, dtype)
    x, w, res = r(G, R, K), r(G, K, N, sc=K ** -0.5), r(G, R, N)
    b = r(G, N) if bias else None
    wk, wv, wb = r(G, N, 8, sc=0.3), r(G, N, 32, sc=0.3), r(G, N, 1, sc=0.3)
    A = (torch.randn(G, 48, 32, generator=g) * 0.1).to(cuda)
    z = torch.rand(G, 48, generator=g).to(cuda)
    y, A2, z2 = grouped_matmul.grouped_matmul_armt_update(x, w, res, wk, wv, wb, A, z, b,
                                                          M=M)
    want = grouped_matmul.grouped_matmul_armt_update_plain(
        *_f32(x, w, res, wk, wv, wb), A, z, None if b is None else b.float(), M=M)
    _close(y, want[0], TOL[dtype])
    # the update is held on the kernel's own y rows, so only its rounding counts
    for got, ref in zip((A2, z2), armt_memory.armt_update_plain(
            *_f32(y[:, -M:], wk, wv, wb), A, z)):
        _close(got, ref, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("G,R,K,N,dm,Dv", [(2, 300, 128, 256, 64, 384),   # P 384: 3 passes of A'
                                           (3, 200, 64, 128, 8, 260),     # a ragged value tile
                                           (2, 150, 64, 96, 16, 250)])    # Dv % 4 != 0
def test_grouped_matmul_armt_update_value_tiles_on_card(cuda, G, R, K, N, dm, Dv):
    """M = 128 memory rows and Dv >= 256 values, so the update runs over
    several 128-value tiles; in bf16 every GEMM launch, the k and v
    projections included, takes the TMA + wgmma route, but for the v
    projection when Dv is not a multiple of 8."""
    g = torch.Generator().manual_seed(R + Dv)
    r = _rand(g, cuda, torch.bfloat16)
    M, P = 128, 6 * dm
    x, w, res = r(G, R, K), r(G, K, N, sc=K ** -0.5), r(G, R, N)
    wk, wv, wb = r(G, N, dm, sc=N ** -0.5), r(G, N, Dv, sc=N ** -0.5), r(G, N, 1, sc=N ** -0.5)
    A = (torch.randn(G, P, Dv, generator=g) * 0.1).to(cuda)
    z = (torch.rand(G, P, generator=g) + 0.5).to(cuda)
    simt = grouped_matmul.simt_launches
    y, A2, z2 = grouped_matmul.grouped_matmul_armt_update(x, w, res, wk, wv, wb, A, z, M=M)
    torch.cuda.synchronize()
    simt = grouped_matmul.simt_launches - simt
    want = grouped_matmul.grouped_matmul_armt_update_plain(*_f32(x, w, res, wk, wv, wb), A, z,
                                                           M=M)
    _close(y, want[0], 1e-2)
    for got, ref in zip((A2, z2), armt_memory.armt_update_plain(
            *_f32(y[:, -M:], wk, wv, wb), A, z)):
        _close(got, ref, 1e-4)
    assert simt == (0 if Dv % 8 == 0 else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,T,dI,dS,G,strided", [
    (2, 37, 200, 4, 1, True),     # ragged channels and tiles, B/C column slices
    (4, 1, 8192, 16, 1, False),   # decode: one token per row
    (6, 50, 130, 8, 3, True),     # a band of 3 groups, each its own A_log and D
    (16, 64, 256, 16, 16, True),  # one row per group, as a B = 1 band step
])
def test_mamba_scan_on_card(cuda, xdtype, N, T, dI, dS, G, strided):
    """y and hT in fp32 against the plain version on the same values: the
    kernel repeats its arithmetic, so summation order and expf are all that
    differ."""
    g = torch.Generator().manual_seed(T + dI)

    def r(*s, sc=1.0):
        return (torch.randn(*s, generator=g) * sc).to(cuda)
    xz = r(N, T, 2 * dI, sc=0.5).to(xdtype)
    x = xz[..., :dI]                               # strided rows, as in_proj's x half
    dt = torch.nn.functional.softplus(r(N, T, dI) - 3.0)
    if strided:                                    # B/C as slices of x_proj's output
        proj = r(N, T, 5 + 2 * dS, sc=0.5)
        Bt, Ct = proj[..., 5:5 + dS], proj[..., 5 + dS:]
    else:
        Bt, Ct = r(N, T, dS, sc=0.5), r(N, T, dS, sc=0.5)
    lead = (G,) if G > 1 else ()
    A_log = torch.log(torch.rand(*lead, dI, dS, generator=g) * 15 + 0.5).to(cuda)
    D = r(*lead, dI)
    h0 = r(N, dI, dS, sc=0.3)
    before = mamba_scan.launches
    y, hT = mamba_scan.mamba_scan(x, dt, Bt, Ct, A_log, D, h0)
    assert mamba_scan.launches == before + 1
    torch.cuda.synchronize()
    yr, hr = mamba_scan.mamba_scan_plain(x.float(), dt, Bt, Ct, A_log, D, h0)
    assert y.dtype == hT.dtype == torch.float32
    _close(y, yr, 1e-4)
    _close(hT, hr, 1e-4)


def _scan_case(g, cuda, dtype, N, T, dI, dS, G):
    """The mixer's operands of one scan: x, raw dt and z as strided views
    (x and z the two halves of in_proj's output, dt a column slice of a
    wider tensor), B/C column slices of x_proj's output, per-group A_log,
    D and dt_bias (fp32), h0."""
    def r(*s, sc=1.0):
        return (torch.randn(*s, generator=g) * sc).to(cuda)
    xz = r(N, T, 2 * dI, sc=0.5).to(dtype)
    raw = (r(N, T, dI + 8) - 1.0).to(dtype)[..., 8:]
    proj = r(N, T, 5 + 2 * dS, sc=0.5)
    lead = (G,) if G > 1 else ()
    A_log = torch.log(torch.rand(*lead, dI, dS, generator=g) * 15 + 0.5).to(cuda)
    return dict(x=xz[..., :dI], z=xz[..., dI:], dt=raw, Bt=proj[..., 5:5 + dS],
                Ct=proj[..., 5 + dS:], A_log=A_log, D=r(*lead, dI),
                dt_bias=r(*lead, dI, sc=0.5) - 3.6, h0=r(N, dI, dS, sc=0.3))


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("N,T,dI,dS,G", [
    (1, 300, 512, 16, 1),         # one row (G = 1), several tiles and a partial one
    (16, 96, 1024, 16, 16),       # a band step: one row per group
    (4, 1, 8192, 16, 1),          # decode: T = 1
    (12, 40, 3072, 16, 4),        # enough blocks of 256 channels to fill the card
    (6, 37, 130, 8, 3),           # ragged channels, 3 groups of 2 rows
])
def test_mamba_scan_fused_on_card(cuda, xdtype, fused, N, T, dI, dS, G):
    """The scan with the mixer's dt prologue and gate epilogue (fused), and
    without them on dt = softplus(raw + bias), against the plain version in
    fp32 on the same values: y and hT within 1e-4 in fp32; in bf16 the
    gated y within bf16 rounding, hT within 1e-4."""
    c = _scan_case(torch.Generator().manual_seed(N * T + dI), cuda, xdtype, N, T, dI, dS, G)
    args = [c[k] for k in ("x", "dt", "Bt", "Ct", "A_log", "D", "h0")]
    want_y, want_h = mamba_scan.mamba_scan_plain(
        *_f32(*args[:2]), *args[2:], dt_bias=c["dt_bias"], z=c["z"].float())
    before = mamba_scan.launches
    if fused:
        y, hT = mamba_scan.mamba_scan(*args, dt_bias=c["dt_bias"], z=c["z"])
        assert y.dtype == xdtype
    else:
        bias = c["dt_bias"].repeat_interleave(N // G, 0)[:, None] if G > 1 else c["dt_bias"]
        dt = torch.nn.functional.softplus(c["dt"].float() + bias)
        y, hT = mamba_scan.mamba_scan(args[0], dt, *args[2:])
        assert y.dtype == torch.float32
        y = y * torch.nn.functional.silu(c["z"].float())
    assert mamba_scan.launches == before + 1
    torch.cuda.synchronize()
    _close(y, want_y, 1e-4 if xdtype == torch.float32 or not fused else 1e-2)
    _close(hT, want_h, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_mamba_scan_row_is_batch_independent_on_card(cuda, fused):
    """A row's y and hT do not depend on the rows scanned beside it: one
    launch over a band of 4 groups x 3 rows (256-channel blocks) gives, to
    the bit, what each row gives alone with its group's A_log, D and dt_bias
    (small blocks), so the diagonal and sequential schedules agree to the
    bit on the kernel."""
    G, B, T, dI, dS = 4, 3, 70, 3072, 16
    c = _scan_case(torch.Generator().manual_seed(5), cuda, torch.bfloat16, G * B, T, dI, dS, G)
    if not fused:
        c["dt"] = torch.nn.functional.softplus(c["dt"].float() - 3.0)
    kw = (lambda sl, g: dict(dt_bias=c["dt_bias"][g], z=c["z"][sl])) if fused else \
        (lambda sl, g: {})
    band = mamba_scan.mamba_scan(*[c[k] for k in ("x", "dt", "Bt", "Ct", "A_log", "D", "h0")],
                                 **(dict(dt_bias=c["dt_bias"], z=c["z"]) if fused else {}))
    for n in (0, 4, 11):
        g, sl = n // B, slice(n, n + 1)
        alone = mamba_scan.mamba_scan(c["x"][sl], c["dt"][sl], c["Bt"][sl], c["Ct"][sl],
                                      c["A_log"][g], c["D"][g], c["h0"][sl], **kw(sl, g))
        for got, want in zip(band, alone):
            assert torch.equal(got[sl], want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,T,D,dm,Dv", [
    (2, 300, 256, 64, 384),   # P 384: 18 K tiles; a partial token tile
    (4, 129, 64, 8, 200),     # P 48: K tiles straddle the three terms; a ragged value tile
    (2, 40, 64, 16, 52),      # Dv % 8 != 0: element stores
    (2, 17, 32, 4, 37),       # Dv odd: element loads of A
])
def test_armt_read_on_card(cuda, dtype, N, T, D, dm, Dv):
    """armt_read at ragged T and Dv against its plain version on the same
    values, with per-group weights: in bf16 the split three-term product on
    the GEMM mainloop, in fp32 the CUDA-core kernel."""
    g = torch.Generator().manual_seed(T + Dv)
    r = _rand(g, cuda, dtype)
    x, wq = r(N, T, D), r(2, D, dm, sc=D ** -0.5)
    A = (torch.randn(N, 6 * dm, Dv, generator=g) * 0.1).to(cuda)
    z = (torch.rand(N, 6 * dm, generator=g) + 0.5).to(cuda)
    before = armt_memory.read_launches
    out = armt_memory.armt_read(x, wq, A, z)
    torch.cuda.synchronize()
    assert armt_memory.read_launches == before + 1 and out.dtype == dtype
    _close(out, armt_memory.armt_read_plain(*_f32(x, wq), A, z), TOL[dtype])


# ---------------------------------------------------------------- long shapes
# The full-attention and full-KV paths: flash at T = S up to 131,072 and
# decode over a 131,136-key cache (hd 64, llama-1b-armt's heads).

def _flash_rows_plain(q, k, v, t0, t1):
    """The plain causal attention of query rows [t0, t1) in fp32 (row t sees
    keys <= t), without the [Hq, T, S] scores of every row."""
    rep = q.shape[1] // k.shape[1]
    kk = k[:, :, :t1].float().repeat_interleave(rep, 1)
    vv = v[:, :, :t1].float().repeat_interleave(rep, 1)
    s = torch.matmul(q[:, :, t0:t1].float(), kk.transpose(-1, -2)) * q.shape[-1] ** -0.5
    vis = torch.arange(t1, device=q.device)[None, :] <= torch.arange(t0, t1, device=q.device)[:, None]
    return torch.matmul(torch.softmax(s.masked_fill(~vis, float("-inf")), -1), vv)


@pytest.mark.cuda
def test_flash_attention_16k_on_card(cuda):
    """T = S = 16,384, 4 q heads over 1 kv head (at 32 heads the plain
    version's fp32 scores would take 34 GB), on the TMA + wgmma route."""
    r = _rand(torch.Generator().manual_seed(16384), cuda, torch.bfloat16)
    q, k, v = r(1, 4, 16384, 64), r(1, 1, 16384, 64), r(1, 1, 16384, 64)
    out = _flash_tc(lambda: flash_attention.flash_attention(q, k, v))
    _close(out, flash_attention.flash_attention_plain(*_f32(q, k, v)), 1e-2)


@pytest.mark.cuda
def test_flash_attention_131k_on_card(cuda):
    """T = S = 131,072 at llama-1b-armt's 32 q heads over 8 kv heads (1,024
    query tiles of 192 rows a head; h*T*hd reaches 2.7e8), held on three
    slices of query rows: the first tile, one mid-sequence and the last."""
    T = 131072
    r = _rand(torch.Generator().manual_seed(T), cuda, torch.bfloat16)
    q, k, v = r(1, 32, T, 64), r(1, 8, T, 64), r(1, 8, T, 64)
    out = _flash_tc(lambda: flash_attention.flash_attention(q, k, v))
    for t0 in (0, 65536 + 37, T - 192):
        _close(out[:, :, t0:t0 + 192], _flash_rows_plain(q, k, v, t0, t0 + 192), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_131k_on_card(cuda, dtype):
    """A cache of 131,136 keys (131,072 tokens + 64): split_plan gives 63
    splits of 2,112 keys, the last of 192. Rows whose lengths leave that
    split full, one key long and empty, and one mid-cache, with a window."""
    from repro_torch.kernels import decode_attention as da
    S = 131136
    chunk, n = da.split_plan(S)
    assert (chunk, n) == (2112, 63) and S - (n - 1) * chunk == 192
    r = _rand(torch.Generator().manual_seed(S), cuda, dtype)
    q, k, v = r(4, 32, 64), r(4, S, 8, 64), r(4, S, 8, 64)
    lengths = torch.tensor([S, (n - 1) * chunk + 1, (n - 1) * chunk, 70000],
                           dtype=torch.int32, device=cuda)
    for window in (0, 5000):
        _close(da.decode_attention(q, k, v, lengths, window=window),
               da.decode_attention_plain(*_f32(q, k, v), lengths, window=window), TOL[dtype])


def _mid_llama(cuda):
    """llama-1b-armt's widths (hd 64, 32 over 8 heads) at 2 layers and a
    small vocabulary, bf16, random weights from a seed."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("llama-1b-armt"), n_layers=2, vocab=1024)
    return cfg, M.init_params(cfg, 0, device=cuda)


@pytest.mark.cuda
def test_cache_prefill_matches_full_mode_on_card(cuda):
    """The cache-mode prefill (one decode_step chunk from position 0, its
    attention on flash over the rows it wrote) against
    forward_hidden(mode='full') on the fused cell, and the chunk's flash
    launches on the TMA + wgmma route, one a layer."""
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine
    cfg, params = _mid_llama(cuda)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 3000)))
    eng = ServeEngine(params, cfg, serve_mode="cache", max_len=3072)
    tc, simt = flash_attention.tc_launches, flash_attention.simt_launches
    logits, state, pos, _ = eng.prefill(prompts)
    torch.cuda.synchronize()
    assert pos == 3000 and tuple(state["pattern"][0]["k"].shape) == (2, 2, 3072, 8, 64)
    assert (flash_attention.tc_launches - tc, flash_attention.simt_launches - simt) == (2, 0)
    with torch.no_grad():
        h, _ = M.forward_hidden(params, cfg, prompts.to(cuda), mode="full")
        want = M.last_logits(params, cfg, h)
    _close(logits, want, 5e-2)


@pytest.mark.cuda
def test_sampling_deterministic_on_card(cuda):
    """temperature / top-k sampling on the device: the same seed gives the
    same tokens, another seed others, top_k = 1 the greedy tokens."""
    from repro_torch.serve import ServeEngine
    cfg, params = _mid_llama(cuda)
    eng = ServeEngine(params, cfg, serve_mode="cache", max_len=512)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 200))
    kw = dict(temperature=1.0, top_k=50)
    a = eng.generate(prompts, 24, seed=7, **kw).tokens
    assert np.array_equal(eng.generate(prompts, 24, seed=7, **kw).tokens, a)
    assert not np.array_equal(eng.generate(prompts, 24, seed=8, **kw).tokens, a)
    greedy = eng.generate(prompts, 24).tokens
    assert np.array_equal(eng.generate(prompts, 24, temperature=0.5, top_k=1).tokens, greedy)


# ------------------------------------------------------------ captured programs
def _bits(t):
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32,
                   torch.int64: torch.int64, torch.bool: torch.bool}[t.dtype])


def _same(a, b):
    """Equal to the bit (NaN and inf included)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _same_state(a, b):
    assert _same(a["pos"], b["pos"])
    for part in ("prelude", "pattern"):
        for da, db in zip(a[part], b[part]):
            assert da.keys() == db.keys()
            for k in da:
                assert _same(da[k], db[k]), (part, k)


def _counts():
    from repro_torch.kernels import build
    return {f"{m.__name__.rsplit('.', 1)[-1]}.{n}": v
            for (m, n), v in build.launch_counts().items()}


def _counted(fn):
    """fn() and the kernel launches it counted."""
    before = _counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in _counts().items() if v != before[k]}


def _graph_and_eager(params, cfg, run, **engine_kw):
    """run(engine) on a graph engine and on an eager one: both results and
    both launch counts (the graph run's first call captures)."""
    from repro_torch.serve import ServeEngine
    return [_counted(lambda: run(ServeEngine(params, cfg, eager=eager, **engine_kw)))
            for eager in (False, True)]


def _mid_falcon(cuda):
    """falcon-mamba-7b's widths (d_model 4096, d_inner 8192, d_state 16) at
    2 layers and a small vocabulary, bf16, random weights from a seed."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=2, vocab=1024)
    return cfg, M.init_params(cfg, 0, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("B,tail,new,sampled", [(1, 1000, 48, False), (2, 990, 40, False),
                                                (2, 1000, 40, True)])
def test_generate_graph_equals_eager_on_card(cuda, B, tail, new, sampled):
    """ARMT generate across a segment flush: the captured step and flush
    against the same programs run eagerly, to the bit in every token, every
    step's logits and the final decode state; the same kernel launches."""
    cfg, params = _mid_llama(cuda)
    prompts = np.random.default_rng(B).integers(0, cfg.vocab, (B, cfg.armt.segment_len + tail))
    kw = dict(temperature=0.8, top_k=40, seed=3) if sampled else {}
    (g, ng), (e, ne) = _graph_and_eager(
        params, cfg, lambda eng: eng.generate(prompts, new, keep=True, **kw))
    assert np.array_equal(g.tokens, e.tokens) and g.finite and e.finite
    assert _same(g.logits, e.logits)
    _same_state(g.state, e.state)
    assert ng == ne and ng["decode_attention.launches"] == (new - 1) * cfg.n_layers


@pytest.mark.cuda
def test_serve_graph_equals_eager_on_card(cuda):
    """6 requests on 4 slots, chunk 8, slots flushing at different steps:
    the captured packed step and masked flush against eager, each
    request's events equal; the same kernel launches."""
    from repro_torch.serve import Request
    cfg, params = _mid_llama(cuda)
    seg = cfg.armt.segment_len
    rng = np.random.default_rng(4)
    spec = [(1000, 40), (990, 30), (1010, 24), (300, 20), (980, 36), (10, 16)]
    reqs = [Request(i, rng.integers(0, cfg.vocab, seg + n), m) for i, (n, m) in enumerate(spec)]

    def run(eng):
        return [(e.req_id, e.token, e.index, e.done, e.finite)
                for e in eng.serve(reqs, n_slots=4, chunk=8)]
    (g, ng), (e, ne) = _graph_and_eager(params, cfg, run)
    assert g == e and len(g) == sum(m for _, m in spec)
    assert ng == ne


@pytest.mark.cuda
def test_cache_generate_graph_equals_eager_on_card(cuda):
    """Full-KV decode from a captured step over a 2,048-row cache: graph
    and eager equal to the bit; the cache keeps its address (no clone)."""
    cfg, params = _mid_llama(cuda)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (2, 1500))
    (g, ng), (e, ne) = _graph_and_eager(
        params, cfg, lambda eng: eng.generate(prompts, 48, keep=True),
        serve_mode="cache", max_len=2048)
    assert np.array_equal(g.tokens, e.tokens) and _same(g.logits, e.logits)
    _same_state(g.state, e.state)
    assert ng == ne


@pytest.mark.cuda
def test_falcon_graph_equals_eager_on_card(cuda):
    """Mamba decode (h and the conv tail in static buffers) from a captured
    step: generate and serve equal graph and eager, the same launches."""
    from repro_torch.serve import Request
    cfg, params = _mid_falcon(cuda)
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, cfg.vocab, (2, 300))
    (g, ng), (e, ne) = _graph_and_eager(
        params, cfg, lambda eng: eng.generate(prompts, 24, keep=True), max_len=256)
    assert np.array_equal(g.tokens, e.tokens) and _same(g.logits, e.logits)
    _same_state(g.state, e.state)
    assert ng == ne and ng["mamba_scan.launches"] > 23 * cfg.n_layers
    reqs = [Request(i, rng.integers(0, cfg.vocab, n), m)
            for i, (n, m) in enumerate([(300, 9), (40, 14), (520, 6)])]

    def run(eng):
        return [(e.req_id, e.token, e.index, e.done) for e in eng.serve(reqs, n_slots=2, chunk=4)]
    (g, ng), (e, ne) = _graph_and_eager(params, cfg, run, max_len=256)
    assert g == e and ng == ne


@pytest.mark.cuda
def test_sequential_segment_graph_on_card(cuda):
    """forward_hidden(schedule='sequential') replays one captured graph
    per segment: equal to the bit to the eager sequential run and to the
    diagonal one (hidden states and every layer's final A and z), with the
    eager run's launch counts; a second call reuses the graph."""
    from repro_torch.models import model as M
    cfg, params = _mid_llama(cuda)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (1, 4 * cfg.armt.segment_len))).to(cuda)

    def fwd(**kw):
        with torch.no_grad():
            return M.forward_hidden(params, cfg, toks, **kw)
    _counted(lambda: fwd(schedule="sequential"))                    # captures
    (hg, fg), ng = _counted(lambda: fwd(schedule="sequential"))
    (he, fe), ne = _counted(lambda: fwd(schedule="sequential", eager=True))
    hd, fd = fwd(schedule="diagonal")
    assert ng == ne and ng["flash_attention.launches"] == 4 * cfg.n_layers
    for h, f in ((he, fe), (hd, fd)):
        assert _same(hg, h)
        for k in ("A", "z"):
            assert _same(fg["pattern"][0][k], f["pattern"][0][k]), k


@pytest.mark.cuda
def test_failed_capture_raises_on_card(cuda):
    """A program that reads a device value on the host cannot be captured:
    the capture raises, nothing falls back."""
    from repro_torch.core.capture import Program
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError):
        Program(lambda: x.sum().item(), cuda, capture=True)
    torch.cuda.synchronize()


# ---------------------------------------------------------------- interleaved admission

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,G,R,K,N,act,bias", [
    (torch.bfloat16, 7, 130, 72, 136, "silu", True),    # TMA + wgmma, ragged
    (torch.bfloat16, 24, 64, 256, 512, None, False),     # 24 groups over 16 layers
    (torch.float32, 5, 37, 50, 29, "gelu", True),        # SIMT
    (torch.bfloat16, 3, 37, 50, 29, None, False),        # SIMT: no 16-byte rows
])
def test_grouped_matmul_layer_index_on_card(cuda, dtype, G, R, K, N, act, bias):
    """A launch with a layer index over a 16-layer stack equals, to the
    bit, the same launch on the weights gathered into group order, on both
    routes; one launch either way."""
    r = _rand(torch.Generator().manual_seed(G + N), cuda, dtype)
    x, w, b = r(G, R, K), r(16, K, N, sc=K ** -0.5), r(16, N) if bias else None
    idx = torch.from_numpy(np.random.default_rng(G).integers(0, 16, G)).to(cuda)
    widx = idx.to(torch.int32)
    before = grouped_matmul.launches
    got = grouped_matmul.grouped_matmul(x, w, b, activation=act, widx=widx)
    want = grouped_matmul.grouped_matmul(x, w[idx].contiguous(),
                                         None if b is None else b[idx].contiguous(),
                                         activation=act)
    torch.cuda.synchronize()
    assert grouped_matmul.launches - before == 2
    assert _same(got, want)
    with pytest.raises(ValueError):
        grouped_matmul.grouped_matmul(x, w, b, widx=idx)          # int64 index


@pytest.mark.cuda
@pytest.mark.parametrize("G,R,K,N,Lw", [
    (6, 1152, 512, 256, 8),    # chatglm3-6b's k/v width (2 kv heads of 128), six bands
    (4, 300, 256, 5120, 16),   # qwen2.5-32b's q width (40 heads of 128)
])
def test_grouped_matmul_bias_layer_index_on_card(cuda, G, R, K, N, Lw):
    """The QKV bias on the GEMM's epilogue with a layer index, as a pooled
    band step of qwen2.5-32b or chatglm3-6b runs it: the bias is the whole
    stack [Lw, N], read through the index, against the plain version."""
    r = _rand(torch.Generator().manual_seed(N + G), cuda, torch.bfloat16)
    x, w, b = r(G, R, K), r(Lw, K, N, sc=K ** -0.5), r(Lw, N, sc=0.02)
    widx = torch.from_numpy(np.random.default_rng(N).integers(0, Lw, G)).to(
        cuda, torch.int32)
    out = _tc_launch(lambda: grouped_matmul.grouped_matmul(x, w, b, widx=widx))
    _close(out, grouped_matmul.grouped_matmul_plain(*_f32(x, w, b), widx=widx.long()), 1e-2)


@pytest.mark.cuda
def test_fused_update_layer_index_on_card(cuda):
    """grouped_matmul_armt_update with a layer index into the stacked down
    projection equals the gathered launch to the bit (y, A, z)."""
    r = _rand(torch.Generator().manual_seed(11), cuda, torch.bfloat16)
    G, R, K, N, M, dm = 5, 160, 256, 128, 32, 16
    P = 6 * dm
    x, w, res = r(G, R, K), r(8, K, N, sc=K ** -0.5), r(G, R, N)
    wk, wv, wb = r(G, N, dm, sc=N ** -0.5), r(G, N, N, sc=N ** -0.5), r(G, N, 1, sc=N ** -0.5)
    A = torch.randn(G, P, N, generator=torch.Generator().manual_seed(2)).to(cuda) * 0.1
    z = torch.rand(G, P, generator=torch.Generator().manual_seed(3)).to(cuda) + 0.5
    idx = torch.tensor([7, 0, 3, 3, 5], device=cuda)
    got = grouped_matmul.grouped_matmul_armt_update(x, w, res, wk, wv, wb, A, z, M=M,
                                                    widx=idx.to(torch.int32))
    want = grouped_matmul.grouped_matmul_armt_update(x, w[idx].contiguous(), res, wk, wv, wb,
                                                     A, z, M=M)
    for a, b in zip(got, want):
        assert _same(a, b)


def _mid_pipeline(cuda, cfg, params, specs):
    """Carries over random embedded segments, (segments, groups run) each."""
    from repro_torch.core import diagonal as D
    from repro_torch.core.schedule import StackLayout
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(params, cfg)
    layout = StackLayout.from_config(cfg)
    rng = np.random.default_rng(12)
    out = []
    for S, done in specs:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S * cfg.armt.segment_len)))
        x = M.embed_segments(params, cfg, toks.to(cuda), cfg.armt.segment_len)
        xs, carry = D.pipeline_init(layout, M.init_state(cfg, 1, cuda), x)
        eng.prefill_step(xs, carry, done)
        out.append((None, xs, carry))
    return eng, out


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4])
def test_pooled_step_equals_each_members_step_on_card(cuda, k):
    """At 2 layers and full width, members of 2, 3 and 4 segments at
    cursors 0, 2 and past the end: the pooled step equals each member's own
    pipeline_step to the bit, and a step of several live members launches
    each kernel once."""
    cfg, params = _mid_llama(cuda)
    specs = [(2, 0), (3, 2), (4, 9)]
    eng, pool = _mid_pipeline(cuda, cfg, params, specs)
    _, own = _mid_pipeline(cuda, cfg, params, specs)
    with torch.no_grad():
        _, n_pool = _counted(lambda: eng.pool_prefill_step_run(1, pool))
        _, n_one = _counted(lambda: eng.prefill_step(own[1][1], own[1][2], 1))
        eng.prefill_step(own[0][1], own[0][2], 1)
        eng.prefill_step(own[2][1], own[2][2], 1)
        eng.pool_prefill_step_run(k, pool)
        for _, xs, carry in own:
            eng.prefill_step(xs, carry, k)
    torch.cuda.synchronize()
    assert n_pool == n_one
    for (_, _, got), (_, _, want) in zip(pool, own):
        assert got["step"] == want["step"]
        for key in ("buf", "ys"):
            assert _same(got[key], want[key]), key
        for leaf in ("A", "z"):
            assert _same(got["state"]["pattern"][0][leaf], want["state"]["pattern"][0][leaf])


@pytest.mark.cuda
def test_interleaved_serve_equals_blocking_on_card(cuda):
    """llama at full width, 2 layers: interleaved serve (k = 1 and 4,
    pooled, fused, oldest first) gives blocking's events, to the token."""
    from repro_torch.serve import Request, ServeEngine
    cfg, params = _mid_llama(cuda)
    seg = cfg.armt.segment_len
    rng = np.random.default_rng(13)
    spec = [(2 * seg + 7, 12), (seg - 3, 20), (3 * seg, 9), (40, 16), (seg + 500, 10)]
    reqs = [Request(i, rng.integers(0, cfg.vocab, n), m) for i, (n, m) in enumerate(spec)]
    eng = ServeEngine(params, cfg)

    def run(**kw):
        return [(e.req_id, e.token, e.index, e.done, e.finite)
                for e in eng.serve(reqs, n_slots=3, chunk=4, **kw)]

    def toks(evs):
        out = {}
        for e in evs:
            out.setdefault(e[0], []).append(e[1])
        return out
    blocking = toks(run(prefill_groups_per_chunk=0))
    for kw in (dict(prefill_groups_per_chunk=1), dict(),
               dict(fused_admission=True), dict(admission_fairness="oldest_first"),
               dict(max_concurrent_admissions=1, prefill_groups_per_chunk=-1)):
        assert toks(run(**kw)) == blocking, kw


@pytest.mark.cuda
def test_interleaved_serve_card_equals_cpu(cuda):
    """Smoke config, fp32: interleaved serve on the card's kernels equals
    the CPU's plain path, token for token."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.serve import Request, ServeEngine
    cfg = get_smoke_config("llama-1b-armt")
    cpu = M.init_params(cfg, 0, device="cpu")
    card = M.Model(cfg, cpu).to(cuda).tree()
    seg = cfg.armt.segment_len
    rng = np.random.default_rng(14)
    reqs = [Request(i, rng.integers(0, cfg.vocab, n), m)
            for i, (n, m) in enumerate([(2 * seg + 3, 9), (seg, 7), (5, 12), (3 * seg + 1, 6)])]

    def served(eng):
        out = {}
        for e in eng.serve(reqs, n_slots=2, chunk=3, prefill_groups_per_chunk=2):
            out.setdefault(e.req_id, []).append(e.token)
        return out
    assert served(ServeEngine(card, cfg)) == served(ServeEngine(cpu, cfg, device="cpu"))


# ---------------------------------------------------------------- state stores

def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.cuda
def test_prefix_snapshot_unchanged_by_replays_on_card(cuda):
    """A snapshot captured on the card is a copy of its own: two hits on
    its prefix (the exact full hit and one with a tail), with the decode
    graphs replayed in between and a serve run after, leave its bits as
    they were; each hit's tokens equal those of an engine without a
    cache."""
    from repro_torch.serve import PrefixCache, Request, ServeEngine
    cfg, params = _mid_llama(cuda)
    seg = cfg.armt.segment_len
    cache = PrefixCache(seg, max_bytes=1 << 30)
    eng, base = ServeEngine(params, cfg, prefix_cache=cache), ServeEngine(params, cfg)
    rng = np.random.default_rng(20)
    shared = rng.integers(0, cfg.vocab, 2 * seg)
    eng.generate(shared[None], 24)
    n, snap = cache.match(shared)
    assert n == 2
    before = [t.clone() for t in _leaves((snap.state, snap.logits))]
    for tail in (0, 300, 0, 300):
        prompt = np.concatenate([shared, rng.integers(0, cfg.vocab, tail)])
        r = eng.generate(prompt[None], 24)
        assert r.cached_segments == 2
        assert np.array_equal(r.tokens, base.generate(prompt[None], 24).tokens)
    list(eng.serve([Request(i, np.concatenate([shared, rng.integers(0, cfg.vocab, 5 + i)]), 9)
                    for i in range(3)], n_slots=2, chunk=4))
    assert all(_same(a, b) for a, b in zip(before, _leaves((snap.state, snap.logits))))


@pytest.mark.cuda
def test_session_unchanged_by_replays_on_card(cuda, tmp_path):
    """A session stored from the decode graphs (generate's program, and a
    serve slot's row) is a copy: further generate and serve calls replaying
    the same graphs leave it as it was, and a spilled and restored session
    resumes to the bit as the one kept in memory."""
    from repro_torch.serve import Request, ServeEngine, SessionStore
    cfg, params = _mid_llama(cuda)
    seg = cfg.armt.segment_len
    rng = np.random.default_rng(21)
    t1, t2 = rng.integers(0, cfg.vocab, seg + 40), rng.integers(0, cfg.vocab, 9)
    kept = ServeEngine(params, cfg, session_store=SessionStore(max_bytes=1 << 30))
    spilled = ServeEngine(params, cfg, session_store=SessionStore(max_bytes=1,
                                                                  spill_dir=tmp_path))
    for eng in (kept, spilled):
        eng.generate(t1[None], 12, session_id="g")
        list(eng.serve([Request("a", t1, 10, "s"), Request("b", t2, 6)], n_slots=2, chunk=4))
    stored = {sid: [t.clone() for t in _leaves(kept.session_store.get(sid).state)]
              for sid in ("g", "s")}
    kept.generate(rng.integers(0, cfg.vocab, (1, 2 * seg + 7)), 20)
    list(kept.serve([Request(i, rng.integers(0, cfg.vocab, 50 * (i + 1)), 12)
                     for i in range(3)], n_slots=2, chunk=4))
    for sid, leaves in stored.items():
        assert all(_same(a, b) for a, b in zip(leaves, _leaves(
            kept.session_store.get(sid).state))), sid
    assert spilled.session_store.stats.spills >= 2
    for sid in ("g", "s"):
        a = kept.generate(t2[None], 10, session_id=sid, keep=True)
        b = spilled.generate(t2[None], 10, session_id=sid, keep=True)
        assert a.resumed and b.resumed
        assert np.array_equal(a.tokens, b.tokens) and _same(a.logits, b.logits)
        _same_state(a.state, b.state)


@pytest.mark.cuda
def test_sequential_capture_under_graphs_on_card(cuda):
    """forward_hidden(capture_states=True) on the sequential schedule
    copies each boundary out of the segment graph's static state after its
    replay: equal to the bit to the eager sequential capture and to the
    diagonal one, every boundary a buffer of its own."""
    from repro_torch.models import model as M
    cfg, params = _mid_llama(cuda)
    toks = torch.from_numpy(np.random.default_rng(22).integers(
        0, cfg.vocab, (1, 3 * cfg.armt.segment_len))).to(cuda)
    with torch.no_grad():
        M.forward_hidden(params, cfg, toks, schedule="sequential")          # captures
        caps = [M.forward_hidden(params, cfg, toks, capture_states=True, **kw)[2]
                for kw in (dict(schedule="sequential"), dict(schedule="sequential", eager=True),
                           dict(schedule="diagonal"))]
        M.forward_hidden(params, cfg, toks.flip(1), schedule="sequential")   # replays again
    for k in ("A", "z"):
        assert caps[0]["pattern"][0][k].shape[0] == 3
        for other in caps[1:]:
            assert _same(caps[0]["pattern"][0][k], other["pattern"][0][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("G,E,C,D,F,pooled", [
    (2, 60, 96, 256, 1408, False),   # qwen2-moe's experts at its capacity (D cut)
    (3, 8, 40, 136, 72, True),       # ragged, a layer index over a 4-layer stack
])
def test_moe_expert_gemm_on_card(cuda, G, E, C, D, F, pooled):
    """The MoE cell's expert products: grouped GEMMs over [G*E, C, D] against
    the view [Lw*E, D, F] of the stacked experts, the silu on the gate's
    epilogue, group (g, e) reading expert widx[g] * E + e with a layer
    index; against torch.bmm on the gathered experts (fp32), each launch on
    the TMA + wgmma route."""
    r = _rand(torch.Generator().manual_seed(E + D), cuda, torch.bfloat16)
    Lw = 4 if pooled else G
    x, wg, wu = r(G * E, C, D), r(Lw, E, D, F, sc=D ** -0.5), r(Lw, E, D, F, sc=D ** -0.5)
    lw = torch.tensor([3, 0, 3][:G], device=cuda) if pooled else torch.arange(G, device=cuda)
    e = (lw[:, None] * E + torch.arange(E, device=cuda)).reshape(-1)
    widx = e.to(torch.int32) if pooled else None
    g = _tc_launch(lambda: grouped_matmul.grouped_matmul(
        x, wg.reshape(-1, D, F), activation="silu", widx=widx))
    u = _tc_launch(lambda: grouped_matmul.grouped_matmul(x, wu.reshape(-1, D, F), widx=widx))
    xf = x.float()
    want_g = torch.bmm(xf, wg.reshape(-1, D, F)[e].float())
    _close(g, want_g * torch.sigmoid(want_g), 1e-2)
    _close(u, torch.bmm(xf, wu.reshape(-1, D, F)[e].float()), 1e-2)


def _moe_cfg(dtype="float32"):
    import dataclasses
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    return dataclasses.replace(cfg, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
                               moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=2,
                                                       d_expert=48, d_shared=64),
                               dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,dispatch,indexed", [(1, "global", False), (2, "global", True),
                                               (2, "per_row", False)])
def test_fused_moe_cell_matches_plain_block_on_card(cuda, B, dispatch, indexed):
    """The fused attn_moe cell on the kernels (fp32, so that its routing is
    the plain block's) against the plain block applied slot by slot over a
    band of both layers; with a layer index [1, 0] over the stack too."""
    import dataclasses
    from repro_torch.core.diagonal import _per_slot_apply
    from repro_torch.models import model as M
    from repro_torch.models.blocks import make_apply_block
    from repro_torch.models.grouped_blocks import make_grouped_apply
    cfg = _moe_cfg()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    p = M.init_params(cfg, 0, device=cuda)["pattern"][0]
    T = cfg.armt.segment_len + cfg.armt.num_mem_tokens
    x = _rand(torch.Generator().manual_seed(B), cuda, torch.float32)(2, B, T, cfg.d_model)
    g = torch.Generator().manual_seed(1)
    st = {k: (torch.rand(v.shape, generator=g) + 0.1).to(cuda)
          for k, v in M.init_state(cfg, B, "cpu")["pattern"][0].items()}
    cell = make_grouped_apply(cfg)
    if indexed:
        got, gst = cell("attn_moe", p, x, st, torch.tensor([1, 0], dtype=torch.int32,
                                                           device=cuda))

        def pick(t):
            return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) else t[[1, 0]]
        p = pick(p)
    else:
        got, gst = cell("attn_moe", p, x, st)
    want, wst = _per_slot_apply(make_apply_block(cfg))("attn_moe", p, x, st)
    _close(got, want, 1e-4)
    _close(gst["A"], wst["A"], 1e-4)


@pytest.mark.cuda
def test_moe_tokens_kernel_experts_match_plain_on_card(cuda):
    """bf16 moe_tokens with the experts on the grouped GEMM against the same
    call with torch.matmul experts: one routing (the same input), so only
    the products' rounding differs."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    cfg = _moe_cfg("bfloat16")
    mcfg = cfg.moe
    r = _rand(torch.Generator().manual_seed(3), cuda, torch.bfloat16)
    D, E, F = cfg.d_model, mcfg.n_experts, mcfg.d_expert
    p = {"router": torch.randn(2, D, E, generator=torch.Generator().manual_seed(4)
                               ).to(cuda) * D ** -0.5,
         "wg": r(2, E, D, F, sc=D ** -0.5), "wu": r(2, E, D, F, sc=D ** -0.5),
         "wd": r(2, E, F, D, sc=F ** -0.5)}
    x = r(2, 300, D)

    def kernel(buf):
        Q, _, C, _ = buf.shape
        xb = buf.reshape(Q * E, C, D)
        g = ops.grouped_gemm(xb, p["wg"].reshape(-1, D, F), activation="silu")
        g = g * ops.grouped_gemm(xb, p["wu"].reshape(-1, D, F))
        return ops.grouped_gemm(g, p["wd"].reshape(-1, F, D)).reshape(Q, E, C, D)

    def plain(buf):
        g = torch.matmul(buf.float(), p["wg"].float())
        u = torch.matmul(buf.float(), p["wu"].float())
        return torch.matmul(torch.nn.functional.silu(g) * u, p["wd"].float()).to(buf.dtype)
    tc = grouped_matmul.tc_launches
    got = moe.moe_tokens(x, p["router"], mcfg, kernel)
    want = moe.moe_tokens(x, p["router"], mcfg, plain)
    assert grouped_matmul.tc_launches - tc == 3
    _close(got, want, 1e-2)


# ------------------------------------------------------------ jamba and cell_block
def _mid_jamba(cuda, dtype="bfloat16", **kw):
    """jamba-1.5-large's pattern (attn without rotary, mamba with a dense
    FFN, mamba_moe) at 2 superblocks, hd 128, narrower (d_model 1024, 8/1
    heads, FFN and 4 experts 2048 wide, top-2, d_inner 2048) and a small
    vocabulary; random weights from a seed."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("jamba-1.5-large-398b")
    cfg = dataclasses.replace(cfg, n_layers=16, d_model=1024, n_heads=8, n_kv_heads=1,
                              d_ff=2048, vocab=1024, dtype=dtype,
                              moe=dataclasses.replace(cfg.moe, n_experts=4, d_expert=2048),
                              **kw)
    return cfg, M.init_params(cfg, 0, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("t", ["attn", "mamba", "mamba_moe"])
def test_jamba_fused_cells_match_plain_block_on_card(cuda, t, B):
    """Each of jamba's fused cells on the kernels (fp32, so that the MoE's
    routing is the plain block's), its input a strided band of a slot
    buffer (stride 8 on the group axis, as the diagonal executor passes
    it), against the plain block slot by slot; the same cell on a
    contiguous copy gives the same bits."""
    from repro_torch.core.diagonal import _per_slot_apply
    from repro_torch.models import model as M
    from repro_torch.models.blocks import make_apply_block
    from repro_torch.models.grouped_blocks import make_grouped_apply
    cfg, params = _mid_jamba(cuda, "float32")
    p = cfg.block_pattern.index(t)
    T = cfg.armt.segment_len + cfg.armt.num_mem_tokens
    buf = _rand(torch.Generator().manual_seed(B), cuda, torch.float32)(16, B, T, cfg.d_model)
    x = buf[p::8]
    g = torch.Generator().manual_seed(1)
    st = {k: (torch.rand(v.shape, generator=g) * 0.1).to(cuda, v.dtype)
          for k, v in M.init_state(cfg, B, "cpu")["pattern"][p].items()}
    cell = make_grouped_apply(cfg)
    got, gst = cell(t, params["pattern"][p], x, st)
    want, wst = _per_slot_apply(make_apply_block(cfg))(t, params["pattern"][p], x, st)
    _close(got, want, 1e-4)
    for k in st:
        _close(gst[k], wst[k], 1e-4)
    again, ast = cell(t, params["pattern"][p], x.contiguous(), st)
    assert _same(again, got) and all(_same(ast[k], gst[k]) for k in st)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2])
def test_jamba_strided_bands_diagonal_equals_sequential_on_card(cuda, B):
    """bf16, 9 segments: the diagonal executor's strided bands (every
    position's cell at G = 2 from step 8) against the sequential schedule
    (the same cells a layer at a time, eager), to the bit: hidden states
    and every layer's final state; every GEMM and flash launch on the TMA +
    wgmma route; one mamba_scan launch per position's band."""
    from repro_torch.core.schedule import StackLayout, band
    from repro_torch.models import model as M
    cfg, params = _mid_jamba(cuda)
    toks = torch.from_numpy(np.random.default_rng(B).integers(
        0, cfg.vocab, (B, 9 * cfg.armt.segment_len))).to(cuda)
    routes = (grouped_matmul.simt_launches, flash_attention.simt_launches)
    with torch.no_grad():
        (hd, fd), nd = _counted(lambda: M.forward_hidden(params, cfg, toks))
        hs, fs = M.forward_hidden(params, cfg, toks, schedule="sequential", eager=True)
    assert (grouped_matmul.simt_launches, flash_attention.simt_launches) == routes
    layout = StackLayout.from_config(cfg)
    cells = sum(layout.position_band(p, *band(i, 9, 16)) is not None
                for i in range(9 + 16 - 1) for p in range(8) if cfg.block_pattern[p] != "attn")
    assert nd["mamba_scan.launches"] == cells < 9 * 14      # one launch a position's band
    assert _same(hd, hs)
    for a, b in zip(fd["pattern"], fs["pattern"]):
        for k in a:
            assert _same(a[k], b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2])
def test_cell_block_fused_cell_on_card(cuda, B):
    """llama-1b-armt's widths at 2 layers, cell_block 256 (1,152 rows: 4
    chunks of 256 and one of 128), each chunk's residual on its down
    projection's epilogue: at B = 1 the blocked attn cell gives the
    unblocked one's output and memory to the bit, running the down
    projections and armt_update in place of the fused update; at B = 2
    (where the unblocked cell rounds the down projection before adding the
    residual) within bf16 tolerance, the memory within 1e-2 as a whole
    (A's rows vary in size); the GEMM's residual epilogue against its plain
    version on a strided residual; with it the diagonal schedule equals
    the sequential one to the bit."""
    import dataclasses
    from repro_torch.models import model as M
    from repro_torch.models.grouped_blocks import make_grouped_apply
    cfg, params = _mid_llama(cuda)
    blk = dataclasses.replace(cfg, cell_block=256)
    T = cfg.armt.segment_len + cfg.armt.num_mem_tokens
    r = _rand(torch.Generator().manual_seed(B), cuda, torch.bfloat16)
    x = r(2, B, T, cfg.d_model)
    g = torch.Generator().manual_seed(1)
    st = {k: (torch.rand(v.shape, generator=g) * 0.1).to(cuda)
          for k, v in M.init_state(cfg, B, "cpu")["pattern"][0].items()}
    with torch.no_grad():
        (y0, s0), n0 = _counted(lambda: make_grouped_apply(cfg)("attn", params["pattern"][0],
                                                               x, st))
        (yb, sb), nb = _counted(lambda: make_grouped_apply(blk)("attn", params["pattern"][0],
                                                               x, st))
    fused = "grouped_matmul.fused_launches"
    if B == 1:
        assert _same(yb, y0) and _same(sb["A"], s0["A"]) and _same(sb["z"], s0["z"])
        assert n0.get(fused) == 1 and "armt_memory.update_launches" not in n0
        assert fused not in nb and nb["armt_memory.update_launches"] == 1
    else:
        _close(yb, y0, 1e-2)
        for k in ("A", "z"):
            assert ((sb[k] - s0[k]).norm() / s0[k].norm()).item() <= 1e-2, k
    assert nb["grouped_matmul.launches"] - n0.get("grouped_matmul.launches", 0) == 4 * 3 + (
        1 if B == 1 else 0)
    xg, w = r(3, 300, 256), r(3, 256, 136, sc=256 ** -0.5)
    res = r(3, 2, 300, 136)[:, 1]                       # strided rows
    got = _tc_launch(lambda: grouped_matmul.grouped_matmul(xg, w, res=res))
    want = grouped_matmul.grouped_matmul_plain(*_f32(xg, w), res=res.float())
    _close(got, want, 1e-2)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, 3 * cfg.armt.segment_len))).to(cuda)
    with torch.no_grad():
        hd, fd = M.forward_hidden(params, blk, toks)
        hs, fs = M.forward_hidden(params, blk, toks, schedule="sequential", eager=True)
    assert _same(hd, hs) and _same(fd["pattern"][0]["A"], fs["pattern"][0]["A"])


# ---------------------------------------------------------------- whisper-medium
@pytest.mark.cuda
@pytest.mark.parametrize("T,S", [(1152, 1500), (128, 1500), (1, 1500), (1500, 1500)])
def test_flash_attention_cross_on_card(cuda, T, S):
    """Whisper's cross-attention and encoder shapes: non-causal, T != S, a
    ragged key length (1,500 = 11 tiles of 128 + 92), hd 64 at rep 1, k/v
    read straight from a cross K/V buffer [G, B, F, H, hd] as [N, H, F, hd]
    views (no copy), on the TMA + wgmma route against the plain version."""
    G, B, H, hd = 2, 1, 16, 64
    r = _rand(torch.Generator().manual_seed(T + S), cuda, torch.bfloat16)
    q = r(G * B, T, H, hd).transpose(1, 2)
    ck, cv = r(G, B, S, H, hd), r(G, B, S, H, hd)
    k, v = (a.reshape(G * B, S, H, hd).transpose(1, 2) for a in (ck, cv))
    assert k.data_ptr() == ck.data_ptr() and flash_attention.route(q, k, v) == "wgmma"
    out = _flash_tc(lambda: flash_attention.flash_attention(q, k, v, causal=False))
    _close(out, flash_attention.flash_attention_plain(*_f32(q, k, v), causal=False), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_cross_on_card(cuda, dtype):
    """Whisper's cross-attention decode: one query of 16 heads of 64 (rep
    1) against a constant cross cache of 1,500 frames, every length 1,500
    (24 splits of 64 keys), against its plain version; a row batched with
    3 others equals the row alone to the bit."""
    from repro_torch.kernels import decode_attention as dattn
    r = _rand(torch.Generator().manual_seed(1500), cuda, dtype)
    q, k, v = r(4, 16, 64), r(4, 1500, 16, 64), r(4, 1500, 16, 64)
    lens = torch.full((4,), 1500, dtype=torch.int32, device=cuda)
    assert dattn.split_plan(1500) == (64, 24) and dattn.head_groups(1, 64) == (1, 1)
    out = dattn.decode_attention(q, k, v, lens)
    _close(out, dattn.decode_attention_plain(*_f32(q, k, v), lens), TOL[dtype])
    alone = dattn.decode_attention(q[2:3], k[2:3], v[2:3], lens[2:3])
    assert _same(alone, out[2:3])


def _mid_whisper(cuda, dtype="bfloat16"):
    """whisper-medium's widths (d_model 1024, 16 heads of 64, d_ff 4096,
    1,500 frames) at 2 encoder and 2 decoder layers and a small
    vocabulary; random weights from a seed, every bias and layernorm
    leaf drawn away from its init value."""
    import dataclasses
    from repro_torch.configs import EncoderConfig, get_config
    from repro_torch.models import model as M
    cfg = get_config("whisper-medium")
    cfg = dataclasses.replace(cfg, n_layers=2, vocab=1024, dtype=dtype, max_position=4096,
                              encoder=EncoderConfig(n_layers=2, n_frames=1500))
    params = M.init_params(cfg, 0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("bq", "bk", "bv", "bi", "bo", "b"):
                v.copy_(torch.randn(v.shape, generator=g, device=cuda) * 0.05)
            elif k == "w":
                v.add_(torch.randn(v.shape, generator=g, device=cuda) * 0.05)
    for tree in (params["pattern"][0], params["enc"], {"f": params["final_norm"]}):
        perturb(tree)
    return cfg, params


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2])
def test_whisper_dec_cell_on_card(cuda, B):
    """The fused dec cell over a band of 2 layers (fp32, 1,152 rows)
    against the plain block slot by slot, within 1e-4, its memory too; in
    bf16 every GEMM and flash launch on the TMA + wgmma route, the cross
    flash one launch over the band's ck/cv; at B = 1 the down projection
    (bias bo) is the fused update."""
    from repro_torch.core.diagonal import _per_slot_apply
    from repro_torch.models import model as M
    from repro_torch.models.blocks import make_apply_block
    from repro_torch.models.grouped_blocks import make_grouped_apply
    for dtype in ("float32", "bfloat16"):
        cfg, params = _mid_whisper(cuda, dtype)
        T = cfg.armt.segment_len + cfg.armt.num_mem_tokens
        r = _rand(torch.Generator().manual_seed(B), cuda, M.DTYPES[dtype])
        x = r(2, B, T, cfg.d_model)
        st = M.init_state(cfg, B, cuda)["pattern"][0]
        g = torch.Generator().manual_seed(2)
        st["A"].copy_(torch.rand(st["A"].shape, generator=g) * 0.1)
        st["z"].copy_(torch.rand(st["z"].shape, generator=g))
        enc = M.encode(params, cfg, r(B, 1500, cfg.d_model))
        M.fill_cross_kv_(params, cfg, {"prelude": (), "pattern": (st,)}, enc)
        with torch.no_grad():
            (got, gst), n = _counted(lambda: make_grouped_apply(cfg)(
                "dec", params["pattern"][0], x, st))
            if dtype == "float32":
                want, wst = _per_slot_apply(make_apply_block(cfg))(
                    "dec", params["pattern"][0], x, st)
                _close(got, want, 1e-4)
                for k in ("A", "z"):
                    assert ((gst[k] - wst[k]).norm() / wst[k].norm()).item() <= 1e-4, k
                continue
        assert "grouped_matmul.simt_launches" not in n and "flash_attention.simt_launches" \
            not in n
        assert n["flash_attention.launches"] == 2
        assert (n.get("grouped_matmul.fused_launches") == 1) == (B == 1)


@pytest.mark.cuda
def test_whisper_forward_and_generate_on_card(cuda):
    """bf16 at whisper-medium's widths (2 + 2 layers): the encoder on the
    kernels within 1e-2 of the plain path; 3 segments, B = 2, diagonal =
    sequential (captured segments) to the bit; generate on graphs against
    an eager engine to the bit in both serve modes; and one engine's graphs
    read each request's frames: frames A, then B, then A again give A's
    tokens twice and B's differ."""
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine
    cfg, params = _mid_whisper(cuda)
    rng = np.random.default_rng(0)
    fr = [torch.from_numpy(rng.standard_normal((2, 1500, cfg.d_model)).astype(np.float32))
          .to(cuda) for _ in range(2)]
    with torch.no_grad():
        enc = M.encode(params, cfg, fr[0])
        plain = M.encode(params, cfg, fr[0], fused=False)
    row = (enc.float() - plain.float()).norm(dim=-1) / plain.float().norm(dim=-1)
    assert row.max().item() <= 1e-2
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 3 * 1024))).to(cuda)
    with torch.no_grad():
        hd, fd = M.forward_hidden(params, cfg, toks, enc_frames=fr[0])
        hs, fs = M.forward_hidden(params, cfg, toks, enc_frames=fr[0], schedule="sequential")
    assert _same(hd, hs) and _same(fd["pattern"][0]["A"], fs["pattern"][0]["A"])
    prompt = rng.integers(0, cfg.vocab, (1, 1024 + 1020))
    for mode in ("armt", "cache"):
        (g, _), (e, _) = _graph_and_eager(
            params, cfg, lambda eng: eng.generate(prompt, 8, keep=True,
                                                  enc_frames=fr[0][:1]),
            serve_mode=mode, max_len=4096)
        assert np.array_equal(g.tokens, e.tokens) and _same(g.logits, e.logits)
        eng = ServeEngine(params, cfg, serve_mode=mode, max_len=4096)
        runs = [eng.generate(prompt, 8, keep=True, enc_frames=fr[f][:1]) for f in (0, 1, 0)]
        assert _same(runs[0].logits, runs[2].logits) and not _same(runs[0].logits,
                                                                   runs[1].logits)


# ---------------------------------------------------------------------------
# training: the kernels' autograd Functions and the training path
# ---------------------------------------------------------------------------

_SCAN_NAMES = ("x", "dt", "Bt", "Ct", "A_log", "D", "h0", "dt_bias", "z")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("N,T,dI,dS,G", [
    (2, 300, 200, 4, 1),      # shared A_log; 3 chunks, the last partial; a ragged block
    (6, 37, 130, 8, 3),       # one partial chunk and sub-chunk; 3 groups of 2 rows
    (4, 256, 1024, 16, 4),    # whole chunks, one row per group (a band step)
    (3, 1, 64, 16, 1),        # one token
])
def test_mamba_scan_backward_on_card(cuda, dtype, fused, N, T, dI, dS, G):
    """MambaScanFn on the card (the forward kernel keeping its states, then
    the reverse scan kernel) against autograd through the plain version in
    fp32 on the same values: every operand's gradient (the raw dt's,
    dt_bias's and z's in the fused form) within 1e-4 (fp32) or 2e-2 (bf16)
    of its norm, with the final state's gradient given too; the forward's
    outputs equal to the no-grad launch's bits; one backward launch; a
    second backward equal to the bit (no atomics); x's gradient x0.98
    (x0.95 in bf16, where x0.98 sits at the tolerance) fails."""
    g = torch.Generator().manual_seed(N * T + dI + fused)
    c = _scan_case(g, cuda, dtype, N, T, dI, dS, G)
    if not fused:
        bias = c["dt_bias"].repeat_interleave(N // G, 0)[:, None] if G > 1 else c["dt_bias"]
        c["dt"] = torch.nn.functional.softplus(c["dt"].float() + bias)
        del c["dt_bias"], c["z"]
    names = [k for k in _SCAN_NAMES if k in c]
    ins = {k: c[k].detach().clone().requires_grad_() for k in names}
    with torch.no_grad():
        y0, h0T = mamba_scan.mamba_scan(*(c[k] for k in names[:7]),
                                        **{k: c[k] for k in names[7:]})
    y, hT = mamba_scan.mamba_scan(*(ins[k] for k in names[:7]), **{k: ins[k] for k in names[7:]})
    assert _same(y.detach(), y0) and _same(hT.detach(), h0T)
    r = _rand(torch.Generator().manual_seed(7), cuda, torch.float32)
    dy, dh = r(*y.shape).to(y.dtype), r(*hT.shape, sc=0.1)
    before = mamba_scan.bwd_launches
    got = torch.autograd.grad((y, hT), [ins[k] for k in names], (dy, dh), retain_graph=True)
    assert mamba_scan.bwd_launches == before + 1
    again = torch.autograd.grad((y, hT), [ins[k] for k in names], (dy, dh))
    assert all(_same(a, b) for a, b in zip(got, again))
    ref = {k: ins[k].detach().float().requires_grad_() for k in names}
    yr, hr = mamba_scan.mamba_scan_plain(*(ref[k] for k in names[:7]),
                                         **{k: ref[k] for k in names[7:]})
    want = torch.autograd.grad((yr, hr), [ref[k] for k in names], (dy.float(), dh))
    tol = 1e-4 if dtype == torch.float32 else 2e-2

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()
    errs = {k: rel(a.float(), b) for k, a, b in zip(names, got, want)}
    assert all(a.dtype == ins[k].dtype for k, a in zip(names, got))
    assert max(errs.values()) <= tol, errs
    assert rel(got[0].float() * (0.98 if dtype == torch.float32 else 0.95), want[0]) > tol


def _backward_case(case, r):
    """(inputs, kernel call, plain call) at small odd shapes."""
    from repro_torch.kernels import ref
    if case.startswith("gemm"):
        act = {"gemm_silu": "silu", "gemm_gelu_bias": "gelu", "gemm_res": None}[case]
        ins = [r(3, 130, 64), r(3, 64, 136, sc=0.125),
               r(3, 136) if case == "gemm_gelu_bias" else None,
               r(3, 130, 136) if case == "gemm_res" else None]
        return (ins, lambda x, w, b, res: grouped_matmul.grouped_matmul(x, w, b, activation=act,
                                                                         res=res),
                lambda x, w, b, res: ref.grouped_matmul_ref(x, w, b, activation=act, res=res))
    if case.startswith("flash"):
        window = 48 if case == "flash_window" else 0
        return ([r(3, 8, 200, 64), r(3, 2, 200, 64), r(3, 2, 200, 64)],
                lambda q, k, v: flash_attention.flash_attention(q, k, v, window=window),
                lambda q, k, v: ref.flash_attention_ref(q, k, v, window=window))
    if case == "read":
        return ([r(4, 130, 256), r(2, 256, 16, sc=0.0625), r(4, 96, 256, sc=0.05),
                 r(4, 96).abs() + 1],
                lambda x, wq, A, z: armt_memory.armt_read(x, wq, A.float(), z.float(), nu=3),
                lambda x, wq, A, z: ref.armt_read_ref(x, wq, A.float(), z.float(), nu=3))
    return ([r(4, 16, 256), r(2, 256, 16, sc=0.0625), r(2, 256, 256, sc=0.0625),
             r(2, 256, 1, sc=0.0625), r(4, 96, 256, sc=0.05), r(4, 96).abs() + 1],
            lambda m, wk, wv, wb, A, z: armt_memory.armt_update(m, wk, wv, wb, A.float(),
                                                                z.float(), nu=3),
            lambda m, wk, wv, wb, A, z: ref.armt_update_ref(m, wk, wv, wb, A.float(),
                                                            z.float(), nu=3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["gemm_silu", "gemm_gelu_bias", "gemm_res", "flash_causal",
                                  "flash_window", "read", "update"])
def test_backward_on_card(cuda, dtype, case):
    """Each training kernel's autograd Function on the card (the kernel
    forward, then its backward formula) against autograd through the plain
    version in fp32 on the same values: every input's gradient within 1e-4
    (fp32) or 2e-2 (bf16) of its norm; a gradient x0.98 (a control) fails."""
    r = _rand(torch.Generator().manual_seed(11), cuda, dtype)
    ins, kernel, plain = _backward_case(case, r)
    ins = [None if t is None else t.requires_grad_() for t in ins]
    outs = kernel(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all(o.grad_fn is not None for o in outs)
    gys = [r(*o.shape).to(o.dtype) for o in outs]
    live = [t for t in ins if t is not None]
    got = torch.autograd.grad(outs, live, gys)
    ref_ins = [None if t is None else t.detach().float().requires_grad_() for t in ins]
    pouts = plain(*ref_ins)
    pouts = pouts if isinstance(pouts, tuple) else (pouts,)
    want = torch.autograd.grad(pouts, [t for t in ref_ins if t is not None],
                               [g.float() for g in gys])
    tol = 1e-4 if dtype == torch.float32 else 2e-2

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()
    errs = [rel(g.float(), w) for g, w in zip(got, want)]
    assert max(errs) <= tol, errs
    assert rel(got[0].float() * 0.98, want[0]) > tol


def _small_llama(dtype):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("llama-1b-armt")
    return dataclasses.replace(cfg, n_layers=3, d_model=256, n_heads=4, n_kv_heads=2,
                               d_head=64, d_ff=512, vocab=512, dtype=dtype,
                               armt=dataclasses.replace(cfg.armt, segment_len=64,
                                                        num_mem_tokens=16, d_mem=16))


@pytest.mark.cuda
def test_training_path_on_card(cuda):
    """A reduced llama (3 layers, d 256, 4/2 heads of 64, segments of 64 +
    16 memory tokens). fp32, 3 segments: lm_loss and every gradient on the
    kernels (diagonal, fused) within 1e-3 of the plain path, each of the
    four kernels launched and the fused update not. bf16, B = 1, 4
    segments: the loss diagonal = sequential to the bit, a train step on
    the TMA + wgmma routes only, and the B = 1 cell's unfused route (under
    gradients) equal to the fused op's forward to the bit."""
    from repro_torch.models import model as M
    from repro_torch.models.grouped_blocks import make_grouped_apply
    from repro_torch.optim import OptimConfig, adamw_init
    from repro_torch.train import make_train_step
    from repro_torch.utils import tree_leaves, tree_unflatten

    def loss_grads(p, cfg, toks, labels, **kw):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
        loss = M.lm_loss(tree_unflatten(p, leaves), cfg, toks, labels, **kw)
        return loss.detach(), torch.autograd.grad(loss, leaves)
    rng = np.random.default_rng(0)
    cfg = _small_llama("float32")
    p = M.init_params(cfg, 0, device=cuda)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 3 * 64 + 1))).to(cuda)
    counts = (armt_memory.read_launches, armt_memory.update_launches,
              grouped_matmul.launches, grouped_matmul.fused_launches, flash_attention.launches)
    lk, gk = loss_grads(p, cfg, toks[:, :-1], toks[:, 1:], schedule="diagonal")
    after = (armt_memory.read_launches, armt_memory.update_launches,
             grouped_matmul.launches, grouped_matmul.fused_launches, flash_attention.launches)
    assert [a > b for a, b in zip(after, counts)] == [True, True, True, False, True]
    lp, gp = loss_grads(p, cfg, toks[:, :-1], toks[:, 1:], schedule="diagonal", fused=False)
    assert abs(lk.item() - lp.item()) <= 1e-4 * abs(lp.item())
    for a, b in zip(gk, gp):
        assert ((a - b).norm() / b.norm().clamp_min(1e-30)).item() <= 1e-3

    cfg = _small_llama("bfloat16")
    p = M.init_params(cfg, 0, device=cuda)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 4 * 64 + 1))).to(cuda)
    ld, _ = loss_grads(p, cfg, toks[:, :-1], toks[:, 1:], schedule="diagonal")
    ls, _ = loss_grads(p, cfg, toks[:, :-1], toks[:, 1:], schedule="sequential")
    assert _same(ld, ls)
    ocfg = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    tc, simt = grouped_matmul.tc_launches, grouped_matmul.simt_launches
    ftc, fsimt = flash_attention.tc_launches, flash_attention.simt_launches
    state, metrics = make_train_step(cfg, ocfg, schedule="diagonal")(
        {"params": p, "opt": adamw_init(p, ocfg)},
        {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    torch.cuda.synchronize()
    assert metrics["skipped"].item() == 0 and np.isfinite(metrics["loss"].item())
    assert grouped_matmul.tc_launches > tc and grouped_matmul.simt_launches == simt
    assert flash_attention.tc_launches > ftc and flash_attention.simt_launches == fsimt
    cell = make_grouped_apply(cfg)
    r = _rand(torch.Generator().manual_seed(3), cuda, torch.bfloat16)
    x = r(3, 1, 80, 256)
    st = {"A": r(3, 1, 96, 256, sc=0.05).float(), "z": r(3, 1, 96).float().abs() + 1}
    with torch.no_grad():
        y0, s0 = cell("attn", p["pattern"][0], x, st)
    y1, s1 = cell("attn", p["pattern"][0], x.clone().requires_grad_(), st)
    assert _same(y0, y1.detach()) and all(_same(s0[k], s1[k].detach()) for k in ("A", "z"))
