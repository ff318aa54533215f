"""Where the fp32 gradients of the diagonal and the sequential schedules part.

llama-1b-armt (the default) at full width and depth, the training check of
chip_smoke.py's (v3): 4 segments, B = 1, weights from seed 0, tokens from
numpy seed 5 after a 2-segment batch, as that script draws them.

1. The gap itself: lm_loss and every leaf's gradient, diagonal against
   sequential, at 1 to 4 segments (the largest leaves printed at 4).
2. The backward products alone: each training kernel's backward on a band
   of 16 groups against the same 16 groups one at a time (the sequential
   schedule's call), on the same random values: the elements of each
   gradient that differ in their bits, and the largest relative
   difference.
3. The gap with those products taken one group at a time on the diagonal
   schedule too (the backwards of the GEMM, armt_read and armt_update
   wrapped to split their groups, flash's a row at a time): if the gap
   closes, the band's summation order is its cause.
4. The memory backwards' cancellation at 2 segments (see whisper's 3),
   for comparison with whisper's.

whisper-medium, whole, the case of chip_smoke.py's (w2): fp32, B = 1, 2
segments, weights from seed 0, tokens from ``lm_stream`` seed 12, frames
from a torch generator at seed 11.

1. Every leaf's gradient on the kernels, diagonal against sequential, and
   the kernels (diagonal) against the plain path (sequential, as (w2)
   holds them), each beside the leaf's norm over the largest leaf's; the
   memory projections layer by layer.
2. The same with the backward products one group at a time on both
   schedules: if the schedules then agree to the bit, the band's
   summation order is the gap's cause.
3. Why the memory projections are so sensitive: in the ARMT read's and
   update's backwards the gradient of phi(q) (phi(k)) is the sum of two
   terms, through the numerator and through the normaliser, that nearly
   cancel when the memory's values are alike. Their ratio |term| / |sum|
   (largest term over the sum, per call with a nonzero memory) is the
   factor by which a relative rounding of the terms grows in the leaf.

    python3 tools/grad_gap.py                      # on a CUDA card, ~2 min
    python3 tools/grad_gap.py whisper-medium       # on a CUDA card, ~1 min
    python3 tools/grad_gap.py whisper-medium --smoke --device cpu   # code check
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import lm_stream  # noqa: E402
from repro_torch.kernels import grad, swap  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.utils import tree_flatten_with_path, tree_leaves, tree_unflatten  # noqa: E402


def rel(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()


def bits_differ(a, b):
    return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).sum())


def per_group(fn, split):
    """fn's backward over a band as one call per group: split(args, g, G)
    -> the args of group g; the outputs concatenated on dim 0."""
    def wrapped(*args, **kw):
        G = split.groups(*args)
        outs = [fn(*split(args, g, G), **kw) for g in range(G)]
        return tuple(None if o[0] is None else torch.cat(o) for o in zip(*outs))
    return wrapped


class GemmSplit:
    """grouped_matmul_bwd(x, w, bias, dy, pre, activation, need): dim 0 is
    the group of every operand."""
    @staticmethod
    def groups(x, *a):
        return x.shape[0]

    def __call__(self, args, g, G):
        x, w, bias, dy, pre, act, need = args
        sl = slice(g, g + 1)
        return (x[sl], w[sl], None if bias is None else bias[sl], dy[sl],
                None if pre is None else pre[sl], act, need)


class RowSplit:
    """The ARMT backwards: rows [N, ...] in G groups of N // G, weights
    [G, ...] per group (2-D shared weights are not split)."""
    def __init__(self, n_rows, n_weights):
        self.n_rows, self.n_weights = n_rows, n_weights   # leading row operands, then weights

    def groups(self, *args):
        w = args[self.n_rows]
        return w.shape[0] if w.dim() == 3 else 1

    def __call__(self, args, g, G):
        out = []
        for i, a in enumerate(args):
            if isinstance(a, torch.Tensor) and a.dim() >= 1:
                if self.n_rows <= i < self.n_rows + self.n_weights:
                    out.append(a[g:g + 1] if a.dim() == 3 else a)
                else:
                    n = a.shape[0] // G
                    out.append(a[g * n:(g + 1) * n])
            else:
                out.append(a)
        return out


class OneGroupAtATime:
    """Within it, the backwards of the GEMM, armt_read and armt_update run
    one group per call, flash's one row per call, on either schedule."""

    def __enter__(self):
        self.orig = (grad.grouped_matmul_bwd, grad.armt_read_bwd, grad.armt_update_bwd,
                     grad.FLASH_BWD_BYTES)
        grad.grouped_matmul_bwd = per_group(self.orig[0], GemmSplit())
        grad.armt_read_bwd = per_group(self.orig[1], RowSplit(1, 1))
        grad.armt_update_bwd = per_group(self.orig[2], RowSplit(1, 3))
        grad.FLASH_BWD_BYTES = 1
        return self

    def __exit__(self, *exc):
        (grad.grouped_matmul_bwd, grad.armt_read_bwd, grad.armt_update_bwd,
         grad.FLASH_BWD_BYTES) = self.orig


def read_terms(x, wq, A, z, g, nu):
    """The two terms of d phi(q) in armt_read_bwd: through the numerator
    (g / den) A^T and through the normaliser d_den z."""
    pq, _ = grad.dpfp_fwd(grad.proj(x.float(), wq.float()), nu)
    A32, z32, g = A.float(), z.float(), g.float()
    num = torch.matmul(pq, A32)
    den = torch.einsum("ntp,np->nt", pq, z32) + grad.EPS
    d_den = -(g * num).sum(-1) / (den * den)
    return (torch.matmul(g / den[..., None], A32.transpose(1, 2)),
            d_den[..., None] * z32[:, None, :])


def update_terms(m, wk, wv, wb, A, z, gA, gz, nu):
    """The terms of d phi(k) in armt_update_bwd: through A' (beta u gA^T),
    through vbar's numerator and normaliser, and through z' (gamma gz and
    gamma's own)."""
    m32, A32, z32, gA, gz = m.float(), A.float(), z.float(), gA.float(), gz.float()
    k = grad.proj(m32, wk.float())
    v = grad.proj(m32, wv.float())
    beta = torch.sigmoid(grad.proj(m32, wb.float()))[..., 0]
    pk, _ = grad.dpfp_fwd(k, nu)
    zk = torch.einsum("nmp,np->nm", pk, z32)
    den = zk + grad.EPS
    vbar = torch.matmul(pk, A32) / den[..., None]
    nn = (pk * pk).sum(-1) + grad.EPS
    gamma = 1.0 - zk / nn
    d_bu = torch.matmul(pk, gA)
    d_vbar = -d_bu * beta[..., None]
    d_num = d_vbar / den[..., None]
    d_gamma = torch.einsum("nmp,np->nm", pk, gz)
    d_zk = -(d_vbar * vbar).sum(-1) / den - d_gamma / nn
    return (torch.matmul(beta[..., None] * (v - vbar), gA.transpose(1, 2)),
            torch.matmul(d_num, A32.transpose(1, 2)),
            gamma[..., None] * gz[:, None, :],
            2 * pk * (d_gamma * zk / (nn * nn))[..., None],
            d_zk[..., None] * z32[:, None, :])


class Cancellation:
    """Within it, every armt_read (armt_update) backward whose memory (whose
    incoming gradient) is nonzero records |largest term| / |sum| of its d
    phi(q) (d phi(k)), in call order."""

    def __enter__(self):
        self.read, self.update = [], []
        self.orig = (grad.armt_read_bwd, grad.armt_update_bwd)

        def ratio(terms):
            return (max(t.double().norm() for t in terms) / sum(terms).double().norm()).item()

        def read_bwd(x, wq, A, z, g, *, nu):
            if A.abs().max() > 0:
                self.read.append(ratio(read_terms(x, wq, A, z, g, nu)))
            return self.orig[0](x, wq, A, z, g, nu=nu)

        def update_bwd(m, wk, wv, wb, A, z, gA, gz, *, nu):
            if gA.abs().max() > 0:
                self.update.append(ratio(update_terms(m, wk, wv, wb, A, z, gA, gz, nu)))
            return self.orig[1](m, wk, wv, wb, A, z, gA, gz, nu=nu)
        grad.armt_read_bwd, grad.armt_update_bwd = read_bwd, update_bwd
        return self

    def __exit__(self, *exc):
        grad.armt_read_bwd, grad.armt_update_bwd = self.orig

    def report(self, label):
        for name, rs in (("read", self.read), ("update", self.update)):
            rs = np.array(rs)
            print(f"{label}: armt_{name} backward, |largest term| / |sum| of d phi over "
                  f"{len(rs)} calls with a nonzero memory: median {np.median(rs):.3g}, max "
                  f"{rs.max():.3g}, each {[float('%.3g' % r) for r in rs]}", flush=True)


def card(dev) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        print("card:", subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                       "--format=csv,noheader"], capture_output=True,
                                      text=True).stdout.strip(), flush=True)


def llama(dev) -> None:
    cfg = replace(get_config("llama-1b-armt"), dtype="float32")
    seg = cfg.armt.segment_len
    p32 = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    names = [n for n, _ in tree_flatten_with_path(p32)]
    trng = np.random.default_rng(5)
    trng.integers(0, cfg.vocab, (1, 2 * seg + 1))                 # (v2)'s batch
    t4 = torch.from_numpy(trng.integers(0, cfg.vocab, (1, 4 * seg + 1))).to(dev)

    def loss_grads(n_seg, schedule):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(p32)]
        loss = M.lm_loss(tree_unflatten(p32, leaves), cfg, t4[:, :n_seg * seg],
                         t4[:, 1:n_seg * seg + 1], schedule=schedule)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(t) if g is None else g
                               for t, g in zip(leaves, gs)]

    def gap(n_seg, label):
        d, s = loss_grads(n_seg, "diagonal"), loss_grads(n_seg, "sequential")
        errs = {n: rel(a, b) for n, a, b in zip(names, d[1], s[1])}
        top = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
        differ = sum(bits_differ(a, b) > 0 for a, b in zip(d[1], s[1]))
        print(f"{label}, {n_seg} segments: loss bits equal {torch.equal(d[0], s[0])}; worst leaf "
              f"{top[0][0]} {top[0][1]:.3e}; leaves differing in any bit {differ} of "
              f"{len(names)}; largest: {[(k, '%.2e' % v) for k, v in top]}", flush=True)
        return max(errs.values())

    # 1. the gap, 1 to 4 segments
    for n in (1, 2, 3, 4):
        gap(n, "1. diagonal vs sequential")

    # 2. each backward at a band of 16 against its groups one at a time
    g = torch.Generator(device=dev).manual_seed(1)

    def r(*s, sc=1.0):
        return torch.randn(*s, generator=g, device=dev) * sc
    G, T, D, F, P, dm = 16, 1152, 2048, 8192, 384, 64
    cases = {
        "GEMM up + silu": (grad.grouped_matmul_bwd, GemmSplit(),
                           (r(G, T, D), r(G, D, F, sc=D ** -0.5), None, r(G, T, F), r(G, T, F),
                            "silu", (True, True, False))),
        "GEMM down + res": (grad.grouped_matmul_bwd, GemmSplit(),
                            (r(G, T, F), r(G, F, D, sc=F ** -0.5), None, r(G, T, D), None, None,
                             (True, True, False))),
        "armt_read": (grad.armt_read_bwd, RowSplit(1, 1),
                      (r(G, T, D), r(G, D, dm, sc=D ** -0.5), r(G, P, D, sc=0.05),
                       r(G, P).abs() + 1, r(G, T, D))),
        "armt_update": (grad.armt_update_bwd, RowSplit(1, 3),
                        (r(G, 128, D), r(G, D, dm, sc=D ** -0.5), r(G, D, D, sc=D ** -0.5),
                         r(G, D, 1, sc=D ** -0.5), r(G, P, D, sc=0.05), r(G, P).abs() + 1,
                         r(G, P, D), r(G, P))),
    }
    for label, (fn, split, args) in cases.items():
        kw = {"nu": 3} if "armt" in label else {}
        band = fn(*args, **kw)
        alone = per_group(fn, split)(*args, **kw)
        out = [(bits_differ(a, b), a.numel(), rel(a, b)) for a, b in zip(band, alone)
               if a is not None]
        print(f"2. {label} backward, band of 16 vs one group at a time: "
              + "; ".join(f"{n:,} of {t:,} elements differ, rel {e:.2e}" for n, t, e in out),
              flush=True)
    del cases, args, band, alone
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # 3. the gap with the backward products one group at a time
    with OneGroupAtATime():
        for n in (2, 4):
            gap(n, "3. the backward products one group at a time")

    # 4. the memory backwards' cancellation, for comparison with whisper's
    with Cancellation() as c:
        loss_grads(2, "sequential")
    c.report("4. 2 segments, sequential")


def whisper(dev, smoke: bool) -> None:
    cfg = replace((get_smoke_config if smoke else get_config)("whisper-medium"),
                  dtype="float32")
    seg = M.segment_len(cfg)
    p32 = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    names = [n for n, _ in tree_flatten_with_path(p32)]
    batch = next(lm_stream(cfg.vocab, 1, 2 * seg, seed=12))
    tokens, labels = (torch.from_numpy(batch[k]).to(dev) for k in ("tokens", "labels"))
    frames = torch.randn(1, cfg.encoder.n_frames, cfg.d_model, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(11))

    def loss_grads(schedule, plain=False):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(p32)]
        if plain:
            with swap.plain_versions():
                loss = M.lm_loss(tree_unflatten(p32, leaves), cfg, tokens, labels,
                                 schedule="sequential", fused=False, enc_frames=frames)
        else:
            loss = M.lm_loss(tree_unflatten(p32, leaves), cfg, tokens, labels,
                             schedule=schedule, enc_frames=frames)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(t) if g is None else g
                               for t, g in zip(leaves, gs)]

    def table(label, d, s, pl):
        """Every leaf: rel diag-vs-seq, rel kernels-vs-plain, norm over the
        largest's; the memory projections layer by layer."""
        norms = [b.double().norm().item() for b in pl[1]]
        top = max(norms)
        differ = sum(bits_differ(a, b) > 0 for a, b in zip(d[1], s[1]))
        print(f"{label}: losses diag / seq / plain {d[0].item():.6f} / {s[0].item():.6f} / "
              f"{pl[0].item():.6f}, diag = seq to the bit {torch.equal(d[0], s[0])}; leaves "
              f"whose diag and seq gradients differ in any bit: {differ} of {len(names)}",
              flush=True)
        rows = sorted(zip(names, d[1], s[1], pl[1], norms), key=lambda r: -rel(r[1], r[2]))
        for n, a, b, c, nb in rows:
            print(f"  {n:28s} diag vs seq {rel(a, b):.3e}  kernels vs plain {rel(a, c):.3e}  "
                  f"|g| / largest {nb / top:.3e}", flush=True)
        for n in ("pattern/0/mem/wk", "pattern/0/mem/wq"):
            i = names.index(n)
            per = [(rel(d[1][i][j], s[1][i][j]), rel(d[1][i][j], pl[1][i][j]),
                    pl[1][i][j].double().norm().item() / top) for j in range(len(pl[1][i]))]
            print(f"  {n} layer by layer (diag vs seq, kernels vs plain, |g| / largest): "
                  + ", ".join(f"{j}: {a:.1e} {b:.1e} {c:.1e}" for j, (a, b, c) in
                              enumerate(per)), flush=True)

    # 1. the gap, as (w2) sees it
    plain = loss_grads("sequential", plain=True)
    table("1. 2 segments, the band's products", loss_grads("diagonal"),
          loss_grads("sequential"), plain)
    # 2. the backward products one group at a time on both schedules
    with OneGroupAtATime():
        table("2. 2 segments, the backward products one group at a time",
              loss_grads("diagonal"), loss_grads("sequential"), plain)
    # 3. the memory backwards' cancellation
    with Cancellation() as c:
        loss_grads("sequential")
    c.report("3. 2 segments, sequential")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="llama-1b-armt",
                    choices=("llama-1b-armt", "whisper-medium"))
    ap.add_argument("--smoke", action="store_true", help="whisper at its smoke size")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    dev = torch.device(a.device)
    card(dev)
    if a.arch == "llama-1b-armt":
        llama(dev)
    else:
        whisper(dev, a.smoke)


if __name__ == "__main__":
    main()
