#!/usr/bin/env python3
"""Where the time of falcon-mamba-7b's serving path goes, on one CUDA card.

    python3 tools/profile_falcon.py [--src DIR] [--layers 64] [--segments 16]
                                    [--decode-steps 16] [--batch 1]
                                    [--trace-dir DIR]

Draws random bf16 weights at full width (seed 0), warms up, then traces
with torch.profiler (CPU and CUDA activity):

  prefill  one diagonal prefill of ``--segments`` 1024-token segments
           (forward_hidden on the fused grouped cell)
  decode   ``--decode-steps`` greedy steps at ``--batch`` rows as
           ``ServeEngine`` runs them: replays of its ``DecodeProgram``'s
           captured step; "decode eager" the same step uncaptured

For each it prints the wall time (host clock, ending in a synchronize; also
of one run without the profiler, which costs host time per op), the
summed device time of every kernel and copy, the device's idle share
(1 - device / wall), the time the host spent blocked on a full launch
queue, the device time split into the scan kernel, GEMMs (cuBLAS and the
port's), PyTorch's elementwise kernels and the rest, and the kernels with
the most device time, grouped by name. ``--src`` imports ``repro_torch``
from another tree (a parent commit unpacked beside this one, say), so two
trees can be profiled in one call. With ``--trace-dir`` a gzipped Chrome
trace of each goes there. Nothing is gated.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

from cardtools import profile

ROOT = Path(__file__).resolve().parent.parent


# device time by kind of kernel, from the kernel's name (first match wins)
KINDS = [("scan", ("mamba_scan",)),
         ("gemm", ("gemm", "gmm_", "xmma", "nvjet", "cutlass", "cublas")),
         ("elementwise", ("elementwise", "vectorized", "reduce_kernel", "CatArrayBatchedCopy",
                          "copy_kernel", "fill_kernel"))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="directory holding the repro_torch package to profile")
    ap.add_argument("--layers", type=int, default=64)
    ap.add_argument("--segments", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace-dir", type=Path, default=None,
                    help="write gzipped Chrome traces here")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_falcon: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip())
    cfg = replace(get_config("falcon-mamba-7b"), n_layers=args.layers)
    params = M.init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    seg = M.DEFAULT_SEG_LEN
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, args.segments * seg))).to(dev)

    def sync():
        torch.cuda.synchronize(dev)

    @torch.no_grad()
    def prefill():
        M.forward_hidden(params, cfg, toks, schedule="diagonal")

    tok = torch.from_numpy(rng.integers(0, cfg.vocab, args.batch)).to(dev)

    def decoder(eager):
        prog = ServeEngine(params, cfg, eager=eager).program(args.batch)
        prog.prepare()
        prog.tok.copy_(tok)

        @torch.no_grad()
        def decode():
            for _ in range(args.decode_steps):
                prog.step()
        return decode

    prefill()
    decode, decode_eager = decoder(False), decoder(True)
    decode()
    decode_eager()
    sync()
    out = {"src": str(args.src), "layers": args.layers, "segments": args.segments, "batch": args.batch,
           "decode_steps": args.decode_steps,
           "prefill": profile("prefill", prefill, sync, KINDS, args.trace_dir, args.top,
                              "falcon"),
           "decode": profile("decode", decode, sync, KINDS, args.trace_dir, args.top,
                             "falcon"),
           "decode eager": profile("decode eager", decode_eager, sync, KINDS, args.trace_dir,
                                   args.top, "falcon")}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
