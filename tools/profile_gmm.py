#!/usr/bin/env python3
"""Where the time of the grouped GEMM and of the fused down projection +
ARMT update goes, on one CUDA card, at llama-1b-armt's full-band shapes.

    python3 tools/profile_gmm.py [--src DIR] [--iters 20]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so the same script measures another tree, a parent commit unpacked beside
this one say, in the same call. With random bf16 inputs from seed 0 at
G = 16 layers, T = 1024 + 128 rows (B = 1), it prints:

  projections  each of the cell's five projection shapes (q/o, k/v, gate
               with silu, up, down): the kernel's and ``torch.bmm``'s median
               device time (``cardtools.time_ms``), the bound (bf16 flops at 989 TFLOP/s or
               bytes at 3.35 TB/s) and the share of it reached;
  fused op     ``grouped_matmul_armt_update`` (x [16,1152,8192] @ w
               [16,8192,2048] + res, M = 128, P = 384, Dv = 2048): its
               median time; its GEMM half alone (``grouped_matmul.launch``
               with the residual) and its update alone
               (``armt_memory.launch_update`` on y's memory rows); and the device kernels of one fused call in
               launch order, from torch.profiler, with their durations
               (each the median over ``--iters`` calls);
  armt_update  the same per-kernel list for ``armt_update`` at the same
               shapes (the B > 1 cell's update);
  host         the host time of one ``grouped_matmul.launch`` call at a tiny
               shape (enqueue only, averaged over 200 calls after a
               synchronize) on each route the tree has, bf16 [1,8,64] @
               [1,64,64] and the same with N = 60: their difference bounds
               what the tensor-core route adds on the host (encoding its two
               TMA tensor maps).

The last line is a JSON object of every number. Nothing is gated.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import cardtools
from cardtools import PEAK_BF16, PEAK_BYTES


def main() -> int:
    args = cardtools.tree_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0])).parse_args()
    cardtools.use_tree(args)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        print("profile_gmm: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import armt_memory, build, grouped_matmul

    smi, _ = cardtools.card()
    print(f"card: {smi} (name, power limit W, max SM MHz); package {args.src.resolve()}",
          flush=True)
    build.lib()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    def time_ms(fn):
        return cardtools.time_ms(fn, args.iters)

    def kernels_of(fn, iters=args.iters):
        """Device kernels of one call of fn in launch order: [(name, median
        us)], from iters profiled calls."""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        per = len(evs) // iters
        if per * iters != len(evs):
            print(f"  ({len(evs)} device events over {iters} calls: not a whole number)")
            return [(e.name, e.time_range.elapsed_us()) for e in evs[:per]]
        rows = []
        for i in range(per):
            durs = [evs[c * per + i].time_range.elapsed_us() for c in range(iters)]
            rows.append((evs[i].name, float(np.median(durs))))
        return rows

    out = {"card": smi, "package": str(args.src.resolve())}
    G, T, D, F, Hkv, hd, dm, Mt = 16, 1152, 2048, 8192, 8, 64, 64, 128
    P = 6 * dm
    print("== projections (median device ms)")
    x, xf = rnd(G, T, D), rnd(G, T, F)
    rows = []
    for label, xin, K, N, act in [("q/o 2048x2048", x, D, D, None),
                                  ("k/v 2048x512", x, D, Hkv * hd, None),
                                  ("gate 2048x8192 silu", x, D, F, "silu"),
                                  ("up 2048x8192", x, D, F, None),
                                  ("down 8192x2048", xf, F, D, None)]:
        w = rnd(G, K, N, scale=K ** -0.5)
        ms = time_ms(lambda: grouped_matmul.grouped_matmul(xin, w, activation=act))
        bmm = time_ms(lambda: torch.bmm(xin, w))
        flops, nbytes = 2.0 * G * T * K * N, 2.0 * G * (T * K + K * N + T * N)
        b_ms = max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
        print(f"  {label:22s} kernel {ms:.4f}  torch.bmm {bmm:.4f}  bound {b_ms:.4f}  "
              f"bound/kernel {b_ms / ms:.3f}  {flops / ms / 1e9:.1f} TFLOP/s")
        rows.append(dict(shape=label, ms=ms, bmm_ms=bmm, bound_ms=b_ms))
        del w
    out["projections"] = rows
    del x

    wd, res = rnd(G, F, D, scale=F ** -0.5), rnd(G, T, D)
    wk, wv, wb = (rnd(G, D, dm, scale=D ** -0.5), rnd(G, D, D, scale=D ** -0.5),
                  rnd(G, D, 1, scale=D ** -0.5))
    A = rnd(G, P, D, scale=0.1, dtype=torch.float32)
    z = torch.rand(G, P, generator=gen).to(dev) + 0.5

    def fused():
        return grouped_matmul.grouped_matmul_armt_update(xf, wd, res, wk, wv, wb, A, z, M=Mt)
    y = torch.empty(G, T, D, dtype=torch.bfloat16, device=dev)
    mem = y[:, T - Mt:]
    grouped_matmul.launch(xf, wd, None, y, res=res)
    dims = armt_memory.check_update(mem, wk, wv, wb, A, z, nu=3)
    split = {"fused_ms": time_ms(fused),
             "gemm_half_ms": time_ms(lambda: grouped_matmul.launch(xf, wd, None, y, res=res)),
             "update_ms": time_ms(lambda: armt_memory.launch_update(mem, wk, wv, wb, A, z, dims)),
             "baddbmm_ms": time_ms(lambda: torch.baddbmm(res, xf, wd))}
    print(f"== grouped_matmul_armt_update: fused {split['fused_ms']:.4f} ms = GEMM half "
          f"{split['gemm_half_ms']:.4f} + update {split['update_ms']:.4f} (each alone); "
          f"torch.baddbmm(res, x, w) {split['baddbmm_ms']:.4f}")
    split["kernels"] = kernels_of(fused)
    for name, us in split["kernels"]:
        print(f"  {us / 1e3:9.4f} ms  {name[:110]}")
    out["fused"] = split
    del xf, wd, res, y

    m = rnd(G, Mt, D)
    upd = {"ms": time_ms(lambda: armt_memory.armt_update(m, wk, wv, wb, A, z)),
           "kernels": kernels_of(lambda: armt_memory.armt_update(m, wk, wv, wb, A, z))}
    print(f"== armt_update m[{G},{Mt},{D}]: {upd['ms']:.4f} ms")
    for name, us in upd["kernels"]:
        print(f"  {us / 1e3:9.4f} ms  {name[:110]}")
    out["armt_update"] = upd

    def host_us(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / n * 1e6
    x1 = rnd(1, 8, 64)
    host = {}
    for n_ in (64, 60):
        w1 = rnd(1, 64, n_)
        o1 = torch.empty(1, 8, n_, dtype=torch.bfloat16, device=dev)
        name = getattr(grouped_matmul, "route", lambda *a: "one route")(x1, w1, o1)
        host[f"N={n_} ({name})"] = min(host_us(lambda: grouped_matmul.launch(x1, w1, None, o1))
                                       for _ in range(3))
    print("== host time per launch() call, tiny shapes: "
          + ", ".join(f"{k} {v:.2f} us" for k, v in host.items()))
    out["host_us"] = host
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
