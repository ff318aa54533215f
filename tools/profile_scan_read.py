#!/usr/bin/env python3
"""Times mamba_scan and armt_read on one CUDA card at the main paths'
shapes, for one tree or two in turns.

    python3 tools/profile_scan_read.py [--src DIR] [--iters 20]
                                       [--outputs FILE] [--against FILE]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so the same script measures another tree, a parent commit unpacked beside
this one say, in the same call (``cardtools.py``). With random inputs from
seed 0 it prints, for each case, the median device time per call, the
device kernels of one call with their counts and median durations, and
the bound:

  armt_read     llama-1b-armt's full-band step: x [16,1152,2048] bf16, per
                group wq [16,2048,64], A [16,384,2048] and z fp32; bound the
                larger of the bf16 products (the q projection and the
                three-term phi A at 989 TFLOP/s; phi z at 67 fp32) and the
                bytes (x, wq, A, z, out once) at 3.35 TB/s;
  scan G=g      falcon-mamba-7b's band step of g layers (g = 1, 4, 16; B =
                1, T = 1024, d_inner 8192, d_state 16): the TPU kernel's
                signature (x bf16, dt fp32 after the softplus, y fp32);
  mixer G=g     the same scan with the mixer's elementwise work around it,
                from the raw dt_proj output (bf16), dt_bias (bf16) and z
                (the strided half of in_proj's output) to the gated bf16 y:
                one fused launch where the tree's mamba_scan takes
                ``dt_bias=`` and ``z=``, else PyTorch's softplus, casts,
                silu and product around the scan. Trees with the fused
                form also time that eager composition around their own
                unfused kernel.

The scans' bound is the larger of the exponentials (d_state a
channel-step, 2 more in the mixer for the softplus and the silu) at 16 a
clock per SM on 132 SMs at the card's maximum SM clock (``nvidia-smi``) and
the bytes (10 a channel-step for the scan, 8 for the fused mixer form, plus
B/C and the state) at 3.35 TB/s. With ``--outputs FILE`` it saves the
outputs of armt_read and of the G = 16 mixer; with ``--against FILE`` it
counts the elements that differ from another run's saved outputs (bit for
bit). The last line is a JSON object of every number. Nothing is gated.
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys

import cardtools
from cardtools import PEAK_BF16, PEAK_BYTES, PEAK_FP32


def main() -> int:
    args = cardtools.tree_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]), outputs=True).parse_args()
    cardtools.use_tree(args)

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import armt_memory, mamba_scan

    if not torch.cuda.is_available():
        print("profile_scan_read: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi, exp_rate = cardtools.card()
    fused = "z" in inspect.signature(mamba_scan.mamba_scan).parameters
    print(f"card: {smi} (name, power limit W, max SM MHz); src {args.src}; mamba_scan "
          f"takes dt_bias/z: {fused}", flush=True)
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    results = {}
    outputs = cardtools.Outputs(args)

    def report(name, fn, bound_ms, save=False):
        diff = outputs.keep(name, fn()) if save else None
        ms = cardtools.time_ms(fn, args.iters)
        split = cardtools.kernels(fn, args.iters)
        results[name] = dict(ms=ms, bound_ms=bound_ms,
                             launches=sum(n for n, _ in split.values()),
                             kernels={k: {"per_call": n, "ms": t} for k, (n, t) in split.items()})
        if diff is not None:
            results[name]["differing_from_against"] = diff
        print(f"  {name}: {ms:.4f} ms  bound {bound_ms:.4f} ms  x bound {ms / bound_ms:.2f}  "
              f"device launches per call {results[name]['launches']:g}", flush=True)
        for k, (n, t) in split.items():
            print(f"    {n:g} x {t:.4f} ms  {k[:90]}", flush=True)

    # armt_read at llama-1b-armt's band step
    G, T, D, dm, P = 16, 1152, 2048, 64, 384
    x, wq = rnd(G, T, D), rnd(G, D, dm, scale=D ** -0.5)
    A = rnd(G, P, D, scale=0.1, dtype=torch.float32)
    z = torch.rand(G, P, generator=gen).to(dev) + 0.5
    flops = 2.0 * G * T * D * dm + 3 * 2.0 * G * T * P * D
    nbytes = 2.0 * G * T * D + 2.0 * G * D * dm + 4.0 * G * P * (D + 1) + 2.0 * G * T * D
    bound = max(flops / PEAK_BF16 + 2.0 * G * T * P / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
    report("armt_read", lambda: armt_memory.armt_read(x, wq, A, z), bound, save=True)
    del x, wq, A, z

    # mamba_scan at falcon-mamba-7b's band steps
    T, dI, dS, dtr = 1024, 8192, 16, 256
    for g in (1, 4, 16):
        steps = float(g * T * dI)
        side = 4.0 * g * T * 2 * dS + 4.0 * g * dI * (dS + 1) + 2 * 4.0 * g * dI * dS
        xc = rnd(g, T, dI, scale=0.5)
        proj = rnd(g, T, dtr + 2 * dS, scale=0.5, dtype=torch.float32)
        Bt, Ct = proj[..., dtr:dtr + dS], proj[..., dtr + dS:]
        A_log = torch.log(torch.arange(1, dS + 1, dtype=torch.float32)
                          * (torch.rand(g, dI, dS, generator=gen) + 0.5)).to(dev)
        Dp = rnd(g, dI, dtype=torch.float32)
        h0 = rnd(g, dI, dS, scale=0.1, dtype=torch.float32)
        raw = rnd(g, T, dI)                              # the dt_proj output
        bias = torch.full((g, dI), -4.6, device=dev, dtype=torch.bfloat16)
        xz = rnd(g, T, 2 * dI)
        zg = xz[..., dI:]
        dt = F.softplus(raw.float() + bias.float()[:, None])
        report(f"scan G={g}", lambda: mamba_scan.mamba_scan(xc, dt, Bt, Ct, A_log, Dp, h0),
               max(steps * dS / exp_rate, (steps * 10 + side) / PEAK_BYTES) * 1e3)

        def composed():
            d = F.softplus(raw.float() + bias.float()[:, None])
            y32, hT = mamba_scan.mamba_scan(xc, d, Bt, Ct, A_log, Dp, h0)
            return y32.to(torch.bfloat16) * F.silu(zg), hT
        mixer_bound = max(steps * (dS + 2) / exp_rate, (steps * 8 + side) / PEAK_BYTES) * 1e3
        if fused:
            report(f"mixer G={g}", lambda: mamba_scan.mamba_scan(
                xc, raw, Bt, Ct, A_log, Dp, h0, dt_bias=bias, z=zg), mixer_bound, save=g == 16)
            report(f"mixer G={g} eager around the unfused kernel", composed, mixer_bound)
        else:
            report(f"mixer G={g}", composed, mixer_bound, save=g == 16)
        del xc, proj, Bt, Ct, A_log, Dp, h0, raw, bias, xz, zg, dt
    outputs.save()
    print(json.dumps({"card": smi, "src": str(args.src), "fused": fused, **results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
