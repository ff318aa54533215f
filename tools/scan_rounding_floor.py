#!/usr/bin/env python3
"""How far a tiny perturbation of the Mamba scan's output moves a deep
random-init falcon-mamba stack: the rounding floor of a model-level check.

    PYTHONPATH=src python3 tools/scan_rounding_floor.py [--device cpu]
        [--layers 64] [--d-model 256] [--dtypes bfloat16 float32]
        [--eps 1e-6 1e-4] [--segments 2]

For each dtype it draws the falcon-mamba-7b stack at ``--layers`` layers and
``--d-model`` width (vocab 4096, seed 0), runs ``--segments`` 1024-token
segments through the sequential schedule, then again with every scan's D
scaled by (1 + eps), which moves y = h . C + D x by a relative eps of its
D x term before the scan rounds its gated output to the model's dtype, and
prints the relative L2 change of each segment's hidden states and the
worst layer's final h. Nothing is gated. A kernel that agrees with its
plain version to eps cannot be held closer than this at the model level.
"""
from __future__ import annotations

import argparse
import sys
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--layers", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-6, 1e-4])
    ap.add_argument("--segments", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, swap
    from repro_torch.models import model as M

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    scan = ops.mamba_scan

    def scaled_D(f):
        """The scan with its D scaled by f."""
        def fn(x, dt, Bt, Ct, A_log, D, h0, **k):
            return scan(x, dt, Bt, Ct, A_log, f * D, h0, **k)
        return fn
    for dtype in args.dtypes:
        cfg = replace(get_config("falcon-mamba-7b"), n_layers=args.layers,
                      d_model=args.d_model, vocab=4096, dtype=dtype)
        params = M.init_params(cfg, 0, device=args.device)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (1, args.segments * M.DEFAULT_SEG_LEN))).to(args.device)

        @torch.no_grad()
        def run():
            h, fin = M.forward_hidden(params, cfg, toks, schedule="sequential", fused=False)
            return h, fin["pattern"][0]["h"]
        h0, H0 = run()
        for eps in args.eps:
            with swap.replaced(mamba_scan=scaled_D(1 + eps)):
                h1, H1 = run()
            per_seg = " ".join(f"{rel(h1[i], h0[i]):.1e}" for i in range(h0.shape[0]))
            worst_h = max(rel(H1[j], H0[j]) for j in range(H0.shape[0]))
            print(f"{dtype}, {args.layers} layers, d_model {args.d_model}: scan D x(1 + "
                  f"{eps:g}) moves the hidden states by {per_seg} (per segment) and the "
                  f"worst layer's h by {worst_h:.1e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
