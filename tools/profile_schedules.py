#!/usr/bin/env python3
"""Where the time of llama-1b-armt's three schedules goes, on one CUDA card.

    python3 tools/profile_schedules.py [--src DIR] [--tokens 16384 131072]
                                       [--cache-rows 131136] [--trace-dir DIR]

Draws random bf16 weights at full width and depth (seed 0) and, for each
prompt length in ``--tokens`` (B = 1), traces one run of each of the
paper's three schedules, all on the port's kernels, after a warm-up:

  full        forward_hidden(mode="full", schedule="sequential"): one
              segment of the whole prompt, no memory (the full-attention
              baseline)
  sequential  forward_hidden(schedule="sequential"): the fused cell one
              (segment, layer) at a time (sequential ARMT), each segment a
              replay of one captured CUDA graph; "sequential eager" the
              same uncaptured
  diagonal    forward_hidden(schedule="diagonal"): the fused cell over the
              anti-diagonal bands (diagonal batching)

then decode as ``ServeEngine`` runs it, each step of its ``DecodeProgram``
a CUDA graph replay ("graph") or the same step uncaptured ("eager"): one
cache-mode step (B = 1) over a full KV cache of ``--cache-rows`` rows, and
``--decode-steps`` ARMT steps at B = 1. For each it prints the wall time
(host clock ending in a synchronize; also of one run without the
profiler), the summed device time of every kernel and copy, the device's
idle share (1 - device / wall), the device time by kind (flash attention,
the grouped GEMM and cuBLAS, the ARMT memory kernels, decode attention,
copies, PyTorch's elementwise and indexing kernels) and the kernels with
the most device time, and last one JSON line. Nothing is gated. ``--src``
imports ``repro_torch`` from another tree (one with ``DecodeProgram``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from cardtools import profile

ROOT = Path(__file__).resolve().parent.parent

# device time by kind of kernel, from the kernel's name (first match wins)
KINDS = [("flash", ("flash_wgmma", "flash_simt")),
         ("decode", ("decode_partial", "decode_combine")),
         ("armt", ("armt_",)),
         ("gemm", ("gmm_", "gemm", "xmma", "nvjet", "cutlass", "cublas")),
         ("copy", ("copy_kernel", "CatArrayBatchedCopy", "Memcpy", "Memset")),
         ("elementwise", ("elementwise", "vectorized", "reduce_kernel", "fill_kernel",
                          "index", "scatter"))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="directory holding the repro_torch package to profile")
    ap.add_argument("--tokens", type=int, nargs="+", default=[16384, 131072])
    ap.add_argument("--cache-rows", type=int, default=131136)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace-dir", type=Path, default=None,
                    help="write gzipped Chrome traces here")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_schedules: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cfg = get_config("llama-1b-armt")
    params = M.init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)

    def sync():
        torch.cuda.synchronize(dev)

    def run(tk, **kw):
        @torch.no_grad()
        def fn():
            h, _ = M.forward_hidden(params, cfg, tk, **kw)
            M.last_logits(params, cfg, h)
        return fn

    out = {"src": str(args.src), "card": smi}
    for n_tok in args.tokens:
        tk = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n_tok))).to(dev)
        for label, kw in [("full", dict(mode="full", schedule="sequential")),
                          ("sequential", dict(schedule="sequential")),
                          ("sequential eager", dict(schedule="sequential", eager=True)),
                          ("diagonal", dict(schedule="diagonal"))]:
            fn = run(tk, **kw)
            fn()
            sync()
            out[f"{label} {n_tok}"] = profile(f"{label} {n_tok}", fn, sync, KINDS,
                                              args.trace_dir, args.top, "schedules")
            torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, eager in (("graph", False), ("eager", True)):
        prog = ServeEngine(params, cfg, serve_mode="cache", max_len=args.cache_rows,
                           eager=eager).program(1)
        prog.prepare()
        for k in ("k", "v"):
            prog.state["pattern"][0][k].normal_(generator=gen)
        prog.state["pos"].fill_(args.cache_rows - 1)
        step = torch.no_grad()(prog.step)
        step()
        sync()
        name = f"cache decode step {args.cache_rows} {label}"
        out[name] = profile(name, step, sync, KINDS, args.trace_dir, args.top, "schedules")
        del prog, step
        torch.cuda.empty_cache()
        prog = ServeEngine(params, cfg, eager=eager).program(1)
        prog.prepare()

        @torch.no_grad()
        def steps():
            for _ in range(args.decode_steps):
                prog.step()
        steps()
        sync()
        name = f"ARMT decode {args.decode_steps} steps B=1 {label}"
        out[name] = profile(name, steps, sync, KINDS, args.trace_dir, args.top, "schedules")
        del prog
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
