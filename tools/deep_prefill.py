#!/usr/bin/env python3
"""How far the untrained llama-1b-armt's diagonal prefill stays near the
sequential one, segment by segment, on one CUDA card.

    python3 tools/deep_prefill.py [--seeds 0 1 2] [--segments 16]
                                  [--configs bf16:16 bf16:4 fp32:2 ...]
                                  [--json out.json]

For each configuration (dtype : layers, full width) and each seed it draws
random weights and a random prompt from the seed, runs the sequential
schedule on the plain path as the reference, and prints each segment's
last-token logits error (relative L2) for four diagonal variants:

  kernels, fused cell      the port's path (B = 1 cell on the fused op)
  kernels, two-launch      the cell's down projection, a bf16 residual add,
                           then the update kernels (the B > 1 cell's rounding)
  plain, fused cell        the kernels' plain versions on the card
  plain, two-launch        the same with the two-launch cell

with the first segment whose logits are not finite and max|z| at the end.
With ``--forced`` each segment instead starts from the state the sequential
plain path reached before it (teacher forcing), so errors do not carry from
one segment to the next; the worst layer's A and z errors are printed too.
Nothing is gated: this measures where a diagonal-vs-sequential check is
well posed for random weights. ``--device cpu --smoke`` runs the smoke
config on the CPU, where the kernel variants are the plain versions.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def variants():
    """label -> ops entries to replace for that diagonal variant."""
    from repro_torch.kernels import ops, swap

    def two_launch(x, w, res, wk, wv, wb, A, z, bias=None, *, M, nu=3):
        y = res + ops.grouped_gemm(x, w, bias)
        A2, z2 = ops.assoc_update(y[:, 0, -M:], wk, wv, wb, A, z, nu=nu)
        return y, A2, z2
    return {"kernels, fused cell": {},
            "kernels, two-launch": {"grouped_gemm_armt_update": two_launch},
            "plain, fused cell": swap.PLAIN,
            "plain, two-launch": dict(swap.PLAIN, grouped_gemm_armt_update=two_launch)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--segments", type=int, default=16)
    ap.add_argument("--configs", nargs="+", default=["bf16:16"],
                    help="dtype:layers at llama-1b-armt width, e.g. bf16:16 fp32:2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="smoke-size widths")
    ap.add_argument("--forced", action="store_true",
                    help="start every segment from the sequential path's state")
    ap.add_argument("--json", help="write every row here as JSON")
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import swap
    from repro_torch.models import model as M

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("deep_prefill: no CUDA device", file=sys.stderr)
            return 2
        print("card:", subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    table = variants()
    base = (get_smoke_config if args.smoke else get_config)("llama-1b-armt")
    dtypes = {"bf16": "bfloat16", "fp32": "float32"}
    rows = []

    def rel(a, b):
        # float64: fp32 norms of the grown state can overflow
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    for spec in args.configs:
        dt, layers = spec.split(":")
        cfg = replace(base, n_layers=int(layers), dtype=dtypes[dt])
        seg = cfg.armt.segment_len
        for seed in args.seeds:
            params = M.init_params(cfg, seed, device=dev)
            rng = np.random.default_rng(seed)
            toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, args.segments * seg))).to(dev)

            def logits(h):
                return M.boundary_logits(params, cfg, h)

            def run(schedule):
                """[S, 1, V] last-token logits and the final z; with
                --forced also per-segment (A, z) errors against the
                sequential path from the same state."""
                with torch.no_grad():
                    if not args.forced:
                        h, fin = M.forward_hidden(params, cfg, toks, schedule=schedule,
                                                  fused=schedule == "diagonal")
                        return logits(h), fin["pattern"][0]["z"], None
                    lgs, st_errs = [], []
                    for s_ in range(args.segments):
                        part = toks[:, s_ * seg:(s_ + 1) * seg]
                        h, fin = M.forward_hidden(params, cfg, part, schedule=schedule,
                                                  fused=schedule == "diagonal",
                                                  state0=ref_states[s_])
                        lgs.append(logits(h))
                        want = ref_states[s_ + 1]["pattern"][0]
                        got = fin["pattern"][0]
                        st_errs.append(max(rel(got[k][i], want[k][i])
                                           for k in ("A", "z") for i in range(cfg.n_layers)))
                    return torch.cat(lgs), fin["pattern"][0]["z"], st_errs
            ref_states = [None]
            if args.forced:
                with torch.no_grad():
                    for s_ in range(args.segments):
                        part = toks[:, s_ * seg:(s_ + 1) * seg]
                        ref_states.append(M.forward_hidden(params, cfg, part, schedule="sequential",
                                                           fused=False, state0=ref_states[s_])[1])
            ref, zs, _ = run("sequential")
            print(f"== {spec} seed {seed}{' forced' if args.forced else ''}: sequential "
                  f"plain max|z| {zs.abs().max().item():.2e}", flush=True)
            for label, entries in table.items():
                with swap.replaced(**entries):
                    lg, z, st_errs = run("diagonal")
                finite = [bool(torch.isfinite(lg[i]).all()) for i in range(lg.shape[0])]
                errs = [rel(lg[i], ref[i]) for i in range(lg.shape[0])]
                first_bad = finite.index(False) + 1 if False in finite else None
                rows.append({"config": spec, "seed": seed, "variant": label,
                             "forced": args.forced, "first_nonfinite_segment": first_bad,
                             "max_abs_z": z.abs().max().item(), "rel_err": errs,
                             "state_rel_err": st_errs})
                print(f"  {label:20s} non-finite from {first_bad or '-':>2}  max|z| "
                      f"{z.abs().max().item():.2e}  per segment: "
                      + " ".join(f"{e:.1e}" for e in errs), flush=True)
                if st_errs is not None:
                    print(f"  {'':20s} worst-layer A/z per segment: "
                          + " ".join(f"{e:.1e}" for e in st_errs), flush=True)
            del params, ref, zs, ref_states
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
