"""Fused grouped cells of the diagonal executor (paper §3.3, §4.2).

Each anti-diagonal step advances a band of G stacked layers at once. A cell
applies one block type to the band's slot slice ``x [G, B, T, D]`` with the
per-layer weights stacked on the group dim.

The ``mamba`` and ``mamba_moe`` cells compute what the reference's vmap of
the plain block over the band computes (the reference has no fused Mamba
cell): the mixer's projections as batched matmuls over ``[G, B*T, .]``, the
depthwise conv and the elementwise work broadcast over the band, and one
``mamba_scan`` launch over all G*B rows, each with its layer's A_log and D
(``models/mamba.py`` ``mamba_block`` takes the band layout as it is); then
the layer's FFN: none (falcon), the dense SwiGLU on the grouped GEMM as the
attn cell's (jamba's ``mamba``), or the MoE (``mamba_moe``,
``moe_ffn_grouped``).

The ``attn`` cell runs through the kernel entry points of
``kernels/ops.py``:

  grouped_gemm       QKV, output and FFN projections as ``[G, B*T, D]``
                     grouped GEMMs; silu rides the gate projection's epilogue,
                     the QKV bias (``cfg.qkv_bias``) the QKV projections'
  segment_attention  one causal GQA launch over N = G*B, reading the 5-D
                     layout through strides
  assoc_read/update  ARMT memory (eqs. 3-6) with per-group weights, fp32 state
  grouped_gemm_armt_update
                     at B == 1, the down projection with the residual added
                     before the cast and the memory update from the last M
                     rows of y, as one op

At B == 1 (every admission, every B = 1 prefill) the memory tokens are the
last M rows of each group's ``[G, T, D]`` output, so the down projection
and the update fuse, as in the reference (grouped_blocks.py:186). The
fused op is forward-only: under gradients the B == 1 cell runs the down
projection with the residual on its epilogue (the same y) and then
``assoc_update``, two launches, as the reference's ``ops.py`` falls back
to separate launches. B > 1
interleaves batch rows, so there the down projection and ``assoc_update``
stay two launches, and y is rounded before the residual is added.

The ``attn_moe`` cell shares the attn cell's front (memory read, QKV,
flash, output projection) and replaces the FFN with the MoE
(``models/moe.py`` ``moe_ffn_grouped``), dispatched per group as the
reference's vmap over the band does: the expert products and the shared
expert on the grouped GEMM, with a layer index read as ``widx·E + e`` of
the flattened expert stack. Its down projections are per expert, so
nothing fuses with the memory update, which is ``assoc_update`` at every
B.

The ``dec`` cell (whisper's decoder layer; the reference has no fused
form and takes its vmap fallback) is the attn cell with the
cross-attention between the self-attention and the FFN: the norm
(layernorm, weight and bias per layer), the biased q projection on the
GEMM, one flash launch without a mask of ``[G*B, H, T, hd]`` against the
band's cross K/V ``[G, B, F, Hkv, hd]`` read as ``[G*B, Hkv, F, hd]``
views (no copy), and the output projection with the residual on its
epilogue. Its FFN is the GELU MLP: the up projection with its bias and
tanh-GELU on the epilogue, the down projection with its bias ``bo`` (on
the fused update at B == 1). The norm and the FFN follow ``cfg.norm`` and
``cfg.act`` in every attn cell. The ``enc`` cell is whisper's encoder
layer (bidirectional, no memory), which ``models/model.py`` ``encode``
runs at G = 1.

In ``"full"`` mode (the full-attention baseline) the attn cell touches no
memory: no ``assoc_read``, no update, and the down projection is
``h + grouped_gemm(...)``. The mamba cells are the same in both modes.

With ``cfg.cell_block > 0`` and more rows than that (the blockwise cell
FFN, the reference's ``blockwise_ffn``), a dense FFN (norm, gate, up,
down, residual) runs over ``[G, B, cell_block, D]`` chunks in order, so
only one chunk's F-wide intermediates are live; the B == 1 fusion of the
down projection with the memory update is then off, as in the reference
(grouped_blocks.py:182-189): the down projections and ``assoc_update``. A
chunk's residual rides its down projection's epilogue (added before the
cast, as the fused update adds it), so a blocked B == 1 cell's output and
memory are the unblocked cell's to the bit on the card.

The attn and dec cells also take a layer index (``widx``, int32 [G] on the
device): its params are then the model's whole stacked pattern and group i
is layer ``widx[i]``. The GEMMs read their weights and biases through the
index (the model's own tensors; no copy), and the small per-layer leaves
(the norm weights, q/k norm weights included, the memory's wq, wk, wv,
wb, and the MoE router) are gathered with ``index_select``. That is how a pooled band step
runs the bands of several pipelines as one cell call (``core/diagonal.py``
``pipeline_step_pool``).
The mamba cells have no such form: their projections are matmuls over the
stacked weights, whose gathered copy would be ~230 MB a layer at
falcon-mamba's width. ``grouped_apply.indexed`` names the cells that take
an index.

On a mesh's 'stage' axis the cells run on a rank's block of the layers:
the stacked params are the block's, so a band is at most L / stage groups
and a pooled step's index is local (the stack's layer minus the block's
first). The cells need no collective of their own there, so the B == 1
cell keeps its fused update on a stage-only mesh; only a 'model' axis
(``tp_active``) splits it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.grad import needs_grad
from repro_torch.models.attention import rope_qk
from repro_torch.models.blocks import check_mode
from repro_torch.models.layers import layernorm, rmsnorm
from repro_torch.models.mamba import mamba_block
from repro_torch.models.moe import moe_ffn_grouped
from repro_torch.parallel.comm import tp_active, tp_enter, tp_gather, tp_reduce


def make_grouped_apply(cfg, mode: str = "segmented"):
    """Returns grouped_apply(btype, stacked_params, x, stacked_state): param
    leaves ``[G, ...]``, x ``[G, B, T, D]``, state leaves ``[G, B, ...]``."""
    check_mode(mode)
    armt_on = mode == "segmented" and cfg.armt is not None
    cb = cfg.cell_block

    def helpers(widx):
        def small(leaf):
            # a per-layer leaf the cell reads whole: the band's, or the
            # indexed layers' gathered
            return leaf if widx is None else leaf.index_select(0, widx)

        def snorm(h, pn):
            # per-layer norm weights (and layernorm's biases) [G, D]
            # broadcast against h [G, B, T, D]
            if cfg.norm == "rmsnorm":
                return rmsnorm(h, {"w": small(pn["w"])[:, None, None, :]})
            return layernorm(h, {"w": small(pn["w"])[:, None, None, :],
                                 "b": small(pn["b"])[:, None, None, :]})

        def gemm(h, w, bias=None, **kw):
            return kops.grouped_gemm(h, w, bias, widx=widx, **kw)
        return small, snorm, gemm

    def attend(p, x, state, widx):
        """The attn cells' front: the memory read, QKV, flash and the
        output projection -> (h, the flat memory state (A, z) or None)."""
        small, snorm, gemm = helpers(widx)
        hd, nq, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        G, B, T, D = x.shape
        N = G * B
        A_f = z_f = None
        if armt_on:
            A_f = state["A"].reshape((N,) + state["A"].shape[2:])
            z_f = state["z"].reshape((N,) + state["z"].shape[2:])
            # a strided band (a position of a several-position pattern) at
            # B = 1 reshapes to a strided view; the read takes contiguous rows
            # on a 'model' axis (A's value dim split) the input and wq are
            # replicated values entering the split read (tp_enter)
            read = kops.assoc_read(tp_enter(x.reshape(N, T, D).contiguous()),
                                   small(tp_enter(p["mem"]["wq"])), A_f, z_f, nu=cfg.armt.nu)
            x = x + tp_gather(read.reshape(G, B, T, -1))

        pa = p["attn"]
        hln = tp_enter(snorm(x, p["ln1"]))
        # the QKV bias rides the GEMM's epilogue (with widx the whole stack
        # [Lw, N], read through the index)
        q = gemm(hln, pa["wq"], pa.get("bq")).reshape(G, B, T, nq, hd)
        k = gemm(hln, pa["wk"], pa.get("bk")).reshape(G, B, T, nkv, hd)
        v = gemm(hln, pa["wv"], pa.get("bv")).reshape(G, B, T, nkv, hd)
        if cfg.qk_norm:   # per-layer head-dim weights [G, hd] against [G, B, T, H, hd]
            q = rmsnorm(q, {"w": small(tp_enter(pa["qn"]["w"]))[:, None, None, None, :]})
            k = rmsnorm(k, {"w": small(tp_enter(pa["kn"]["w"]))[:, None, None, None, :]})
        q, k = rope_qk(q, k, cfg)
        o = kops.segment_attention(q, k, v, causal=True, window=cfg.sliding_window)
        return x + tp_reduce(gemm(o.reshape(G, B, T, nq * hd), pa["wo"])), A_f, z_f

    def update(p, y, state, A_f, z_f, widx):
        """The ARMT update from the last M rows of each group's y (two
        launches at any B) -> the new state."""
        small = helpers(widx)[0]
        G, B, _, D = y.shape
        M, pm = cfg.armt.num_mem_tokens, p["mem"]
        A2, z2 = kops.assoc_update(tp_enter(y[:, :, -M:, :].reshape(G * B, M, D)),
                                   small(tp_enter(pm["wk"])), small(pm["wv"]),
                                   small(tp_enter(pm["wb"])), A_f, z_f, nu=cfg.armt.nu)
        return dict(state, A=A2.reshape(state["A"].shape), z=z2.reshape(state["z"].shape))

    def ffn_mid(p, h, widx):
        """The dense FFN's F-wide product of the band: SwiGLU's silu(gate)
        (silu on the gate projection's epilogue) times up, or the GELU
        MLP's gelu(h Wi + bi) (bias and GELU on the epilogue), after the
        norm -> (it, the down projection's weight and bias)."""
        snorm, gemm = helpers(widx)[1:]
        pf = p["ffn"]
        h2 = tp_enter(snorm(h, p["ln2"]))
        if cfg.act == "silu":
            return (gemm(h2, pf["wg"], activation="silu") * gemm(h2, pf["wu"]),
                    pf["wd"], None)
        return gemm(h2, pf["wi"], pf.get("bi"), activation="gelu"), pf["wo"], pf.get("bo")

    def ffn(p, h, widx):
        """h + the dense FFN of the band (``ffn_mid``, then the down
        projection): whole, or chunk by chunk of cell_block rows over a
        segment of more. A chunk's residual rides its down projection's
        epilogue, added before the one cast as the B == 1 fused update
        adds it, so a blocked B == 1 cell gives the unblocked one's rows
        to the bit. Unblocked, the GELU MLP's residual rides the epilogue
        too (one rounding, as the fused update's); SwiGLU's is added after
        the cast (the bits the llama gates pin)."""
        gemm = helpers(widx)[2]

        def down(mid, wd, bd, res):
            # a row-parallel product is a partial sum: the residual (and
            # the bias) is added once, after the all-reduce
            if tp_active():
                y = tp_reduce(gemm(mid, wd))
                return res + (y if bd is None else y + bd)
            return gemm(mid, wd, bd, res=res)
        T = h.shape[2]
        if not 0 < cb < T:
            mid, wd, bd = ffn_mid(p, h, widx)
            if cfg.act == "gelu":
                return down(mid, wd, bd, h)
            return h + tp_reduce(gemm(mid, wd, bd))
        y = torch.empty_like(h)
        for i in range(0, T, cb):
            hc = h[:, :, i:i + cb]
            mid, wd, bd = ffn_mid(p, hc, widx)
            y[:, :, i:i + cb] = down(mid, wd, bd, hc)
        return y

    def cross(p, h, state, widx):
        """h + the dec cell's cross-attention: the norm, the biased q
        projection on the GEMM, one flash launch without a mask against the
        band's ck/cv [G, B, F, Hkv, hd] (read through their strides, no
        copy), the output projection with h added on its epilogue."""
        snorm, gemm = helpers(widx)[1:]
        G, B, T, _ = h.shape
        px = p["xattn"]
        q = gemm(snorm(h, p["ln_x"]), px["wq"], px.get("bq")).reshape(
            G, B, T, cfg.n_heads, cfg.head_dim)
        o = kops.segment_attention(q, state["ck"], state["cv"], causal=False)
        return gemm(o.reshape(G, B, T, cfg.n_heads * cfg.head_dim), px["wo"], res=h)

    def fused_attn(p, x, state, widx=None):
        small = helpers(widx)[0]
        B, T = x.shape[1], x.shape[2]
        h, A_f, z_f = attend(p, x, state, widx)
        if "xattn" in p:       # the dec cell
            h = cross(p, h, state, widx)
        if not armt_on:
            return ffn(p, h, widx), dict(state)
        M, pm = cfg.armt.num_mem_tokens, p["mem"]
        if M > 0 and B == 1 and not 0 < cb < T and not tp_active():
            mid, wd, bd = ffn_mid(p, h, widx)
            wk, wv, wb = small(pm["wk"]), small(pm["wv"]), small(pm["wb"])
            if needs_grad(mid, wd, h, wk, wv, wb, A_f, z_f, bd):
                # the fused op is forward-only: the same y (its residual on
                # the epilogue, one cast) and the update from its last M rows
                y = helpers(widx)[2](mid, wd, bd, res=h)
                return y, update(p, y, state, A_f, z_f, widx)
            y, A2, z2 = kops.grouped_gemm_armt_update(
                mid, wd, h, wk, wv, wb, A_f, z_f, bd, M=M, nu=cfg.armt.nu, widx=widx)
            return y, dict(state, A=A2.reshape(state["A"].shape),
                           z=z2.reshape(state["z"].shape))
        y = ffn(p, h, widx)
        if M == 0:
            return y, dict(state)
        return y, update(p, y, state, A_f, z_f, widx)

    def fused_attn_moe(p, x, state, widx=None):
        snorm = helpers(widx)[1]
        h, A_f, z_f = attend(p, x, state, widx)
        y = h + moe_ffn_grouped(snorm(h, p["ln2"]), p["moe"], cfg.moe, widx)
        if not armt_on or cfg.armt.num_mem_tokens == 0:
            return y, dict(state)
        return y, update(p, y, state, A_f, z_f, widx)

    def fused_mamba(p, x, state):
        h, new = mamba_block(p, x, cfg.ssm, state)
        return (ffn(p, h, None) if "ffn" in p else h), new

    def fused_mamba_moe(p, x, state):
        h, new = mamba_block(p, x, cfg.ssm, state)
        return h + moe_ffn_grouped(helpers(None)[1](h, p["ln2"]), p["moe"], cfg.moe), new

    def fused_enc(p, x, state):
        """Whisper's encoder layer over [G, B, F, D] (the encoder runs it at
        G = 1): the norm, the biased QKV on the GEMM, one flash launch
        without a mask, the output projection with the residual on its
        epilogue, then the GELU MLP."""
        snorm, gemm = helpers(None)[1:]
        G, B, F, _ = x.shape
        hd, nq, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        pa = p["attn"]
        hln = snorm(x, p["ln1"])
        q = gemm(hln, pa["wq"], pa.get("bq")).reshape(G, B, F, nq, hd)
        k = gemm(hln, pa["wk"], pa.get("bk")).reshape(G, B, F, nkv, hd)
        v = gemm(hln, pa["wv"], pa.get("bv")).reshape(G, B, F, nkv, hd)
        o = kops.segment_attention(q, k, v, causal=False)
        h = gemm(o.reshape(G, B, F, nq * hd), pa["wo"], res=x)
        return ffn(p, h, None), dict(state)

    cells = {"attn": fused_attn, "attn_moe": fused_attn_moe, "mamba": fused_mamba,
             "mamba_moe": fused_mamba_moe, "dec": fused_attn, "enc": fused_enc}

    def grouped_apply(t, p, x, state, widx=None):
        if t not in cells:
            raise ValueError(f"no fused cell for block type {t!r}")
        if widx is None:
            return cells[t](p, x, state)
        if t not in grouped_apply.indexed:
            raise ValueError(f"the {t!r} cell takes no layer index")
        return cells[t](p, x, state, widx)

    grouped_apply.indexed = ("attn", "attn_moe", "dec")
    return grouped_apply
