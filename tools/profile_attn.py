#!/usr/bin/env python3
"""Times the flash and decode attention kernels on one CUDA card, at
llama-1b-armt's shapes, beside scaled_dot_product_attention.

    python3 tools/profile_attn.py [--src DIR] [--iters 20]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so the same script measures another tree, a parent commit unpacked beside
this one say, in the same call (``cardtools.py``). With random bf16 inputs
from seed 0 it prints, for each case, the kernel's median device time per
call, the device kernels of the call with their median durations, the
time of one ``scaled_dot_product_attention`` call on
the same values (contiguous
[N,H,T,hd] copies for flash; [B,H,1,hd] against a boolean length mask for
decode), the bound and the kernel's multiple of it:

  flash hd64   the full-band cell of llama-1b-armt through
               ``ops.segment_attention``: q [16,1,1152,32,64], k/v
               [16,1,1152,8,64], causal; the bound is the larger of the
               bf16 products at 989 TFLOP/s and the exponentials,
               N * Hq * T(T+1)/2, at 16 a clock per SM on 132 SMs at the
               card's maximum SM clock (``nvidia-smi``);
  flash hd128  the same with llama-3b-armt's heads: 24 q heads, 8 kv heads,
               hd 128;
  decode       4 slots of a 1152-row cache, 32 q heads, 8 kv heads, hd 64,
               every slot at 1024 keys, then lengths (1024, 517, 1, 1000);
               the bound is the bytes of the valid K/V rows, q and out at
               3.35 TB/s;
  decode rep16 the same cache with chatglm3-6b's heads: 32 q heads over 2
               kv heads of 128 dims, every slot at 1024 keys;
  flash hd80   the flash hd64 case with h2o-danube-1.8b's heads: 32 q
               heads, 8 kv heads, hd 80;
  flash hd112  the same with kimi-k2-1t-a32b's heads: 64 q heads, 8 kv
               heads, hd 112 (a tree from before hd 112's TMA + wgmma
               route runs it on flash_simt, so against such a tree its
               count is not a claim of equal bits).

With ``--outputs FILE`` it saves each case's output; with ``--against
FILE`` it counts the output elements that differ from another run's saved
outputs (the parent's kernels against the change's, bit for bit), and
prints the cases with none differing. The last line is a JSON object of
every number. Nothing is gated.
"""
from __future__ import annotations

import argparse
import json
import sys

import cardtools
from cardtools import PEAK_BF16, PEAK_BYTES


def main() -> int:
    args = cardtools.tree_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]), outputs=True).parse_args()
    cardtools.use_tree(args)

    import torch
    from repro_torch.kernels import decode_attention, ops

    if not torch.cuda.is_available():
        print("profile_attn: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi, exp_rate = cardtools.card()
    print(f"card: {smi} (name, power limit W, max SM MHz); src {args.src}", flush=True)
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)

    results = {}
    outputs = cardtools.Outputs(args)

    def report(name, kernel, sdpa, bound_ms):
        diff = outputs.keep(name, kernel())
        ms, sdpa_ms = (cardtools.time_ms(f, args.iters) for f in (kernel, sdpa))
        split = {k: t for k, (_, t) in cardtools.kernels(kernel, args.iters).items()}
        results[name] = dict(ms=ms, sdpa_ms=sdpa_ms, bound_ms=bound_ms, kernels=split)
        if diff is not None:
            results[name]["differing_from_against"] = diff
        print(f"  {name}: kernel {ms:.4f} ms  sdpa {sdpa_ms:.4f} ms  bound {bound_ms:.4f} ms  "
              f"kernel/bound {ms / bound_ms:.2f}  kernel/sdpa {ms / sdpa_ms:.2f}", flush=True)
        for k, v in split.items():
            print(f"    {v:.4f} ms  {k[:90]}", flush=True)

    for name, (G, T, Hq, Hkv, hd) in [("flash hd64", (16, 1152, 32, 8, 64)),
                                      ("flash hd128", (16, 1152, 24, 8, 128))]:
        q5, k5, v5 = rnd(G, 1, T, Hq, hd), rnd(G, 1, T, Hkv, hd), rnd(G, 1, T, Hkv, hd)
        qc, kc, vc = (a[:, 0].transpose(1, 2).contiguous() for a in (q5, k5, v5))
        pairs = T * (T + 1) / 2
        bound = max(4.0 * G * Hq * hd * pairs / PEAK_BF16, G * Hq * pairs / exp_rate) * 1e3
        report(name, lambda: ops.segment_attention(q5, k5, v5, causal=True),
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qc, kc, vc, is_causal=True, enable_gqa=True), bound)
        del q5, k5, v5, qc, kc, vc

    # the cases added later draw their inputs after the earlier ones', so
    # that a tree timed before them gets the same inputs for those
    B, S = 4, 1152
    for label, Hq, Hkv, hd, cases in [("decode", 32, 8, 64, [(1024,) * B, (1024, 517, 1, 1000)]),
                                      ("decode rep16", 32, 2, 128, [(1024,) * B])]:
        qd, kd, vd = rnd(B, Hq, hd), rnd(B, S, Hkv, hd), rnd(B, S, Hkv, hd)
        q4, k4, v4 = qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)
        for lens in cases:
            L = torch.tensor(lens, dtype=torch.int32, device=dev)
            mask = (torch.arange(S, device=dev) < L[:, None])[:, None, None, :]
            nbytes = 2.0 * 2 * sum(lens) * Hkv * hd + 2.0 * 2 * B * Hq * hd + 4.0 * B
            report(f"{label} lengths {lens}",
                   lambda: decode_attention.decode_attention(qd, kd, vd, L),
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       q4, k4, v4, attn_mask=mask, enable_gqa=True), nbytes / PEAK_BYTES * 1e3)
    for name, (G, T, Hq, Hkv, hd) in [("flash hd80", (16, 1152, 32, 8, 80)),
                                      ("flash hd112", (16, 1152, 64, 8, 112))]:
        q5, k5, v5 = rnd(G, 1, T, Hq, hd), rnd(G, 1, T, Hkv, hd), rnd(G, 1, T, Hkv, hd)
        qc, kc, vc = (a[:, 0].transpose(1, 2).contiguous() for a in (q5, k5, v5))
        pairs = T * (T + 1) / 2
        bound = max(4.0 * G * Hq * hd * pairs / PEAK_BF16, G * Hq * pairs / exp_rate) * 1e3
        report(name, lambda: ops.segment_attention(q5, k5, v5, causal=True),
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qc, kc, vc, is_causal=True, enable_gqa=True), bound)
        del q5, k5, v5, qc, kc, vc
    outputs.save()
    if args.against:
        same = [k for k, v in results.items() if v.get("differing_from_against") == 0]
        print(f"  cases with 0 differing elements against {args.against}: {same}", flush=True)
    print(json.dumps({"card": smi, "src": str(args.src), **results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
