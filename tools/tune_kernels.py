#!/usr/bin/env python3
"""Autotune the port's kernels at one architecture's main-path shapes, on
one CUDA card.

    python3 tools/tune_kernels.py --arch llama-1b-armt [--cache PATH] [--repeats 3]

Runs ``kernels.autotune.Autotuner.get_or_tune`` for every op on the arch's
path, at its full-width band shapes (G = 16 layers, B = 1, the segment
plus its memory tokens: T = 1,152 for the ARMT configs, 1,024 for a pure
Mamba stack) and at its decode shapes (4 slots), on random operands drawn
from ``--seed`` on the card (``path_cases``, the one list of these shapes;
chip_smoke.py's phase (y) tunes from it too). Winners go to the dispatch
cache (``--cache``, default ``REPRO_TORCH_KERNEL_CACHE`` or
``~/.cache/repro_torch/kernel_cache.json``), where the kernels' wrappers
read them in any later process; a key already there is a cache hit and is
not swept again.

Prints, with the card's name and power limit, each candidate's device
time (the best of ``--repeats`` paired rounds, CUDA events behind a spin
of the card), the kernel's own rule's pick at that shape
(``dispatch.rule_config``), the winner, what the cache stores (the winner
with each block equal to the rule's pick set to 0, so the other shapes of
its bucket run their own rule's pick) and any candidate rejected (not
within the tolerance of the plain version, or not equal to the heuristic
to the bit) or dropped (raised); then the autotune counters; the last line
is a JSON object of all of it. Writes no benchmark file. The ARMT
attention configs (llama-*-armt, minitron-8b, qwen2.5-32b, chameleon-34b,
h2o-danube-1.8b, chatglm3-6b) and falcon-mamba-7b are listed; another arch
exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def path_cases(cfg, device, *, G: int = 16, B: int = 1, slots: int = 4, seed: int = 0):
    """(op, label, args, kwargs) for every op call on ``cfg``'s main path:
    the band step of G layers at batch B and a decode step over ``slots``
    rows, the operands in the kernel wrappers' layouts (the shapes each
    wrapper keys its dispatch on), drawn on ``device`` from ``seed`` in
    the config's dtype. A generator: each case's operands are made when it
    is reached."""
    import torch

    from repro_torch.models.model import DEFAULT_SEG_LEN

    types = set(cfg.layer_types)
    gen = torch.Generator(device=device).manual_seed(seed)
    act = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    f32 = torch.float32

    def rnd(*shape, scale=1.0, dtype=act):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

    def positive(*shape):
        return torch.rand(*shape, generator=gen, device=device) + 0.5

    G = min(G, cfg.n_layers)
    N = G * B
    D = cfg.d_model
    if types == {"attn"} and cfg.armt is not None and cfg.moe is None:
        Hq, Hkv, hd, F = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
        mem = cfg.armt
        M, dm, nu, Dv = mem.num_mem_tokens, mem.d_mem, mem.nu, mem.d_val or D
        P, T = 2 * nu * dm, mem.segment_len + mem.num_mem_tokens

        def state(n):
            return rnd(n, P, Dv, scale=0.1, dtype=f32), positive(n, P)

        def proj(K, Nout, bias=False):
            w = rnd(G, K, Nout, scale=K ** -0.5)
            return (w, rnd(G, Nout, scale=0.1)) if bias else (w,)
        yield ("armt_read", "memory read", (rnd(N, T, D), rnd(G, D, dm, scale=D ** -0.5),
                                            *state(N)), {"nu": nu})
        yield ("grouped_matmul", "q projection",
               (rnd(G, B * T, D), *proj(D, Hq * hd, cfg.qkv_bias)), {})
        yield ("grouped_matmul", "k and v projections",
               (rnd(G, B * T, D), *proj(D, Hkv * hd, cfg.qkv_bias)), {})
        yield ("grouped_matmul", "output projection", (rnd(G, B * T, Hq * hd), *proj(Hq * hd, D)),
               {})
        yield ("grouped_matmul", f"FFN in ({cfg.act})", (rnd(G, B * T, D), *proj(D, F)),
               {"activation": cfg.act})

        def heads(n):
            return rnd(G, B, T, n, hd).reshape(N, T, n, hd).transpose(1, 2)
        yield ("flash_attention", "band attention", (heads(Hq), heads(Hkv), heads(Hkv)),
               {"causal": True, "window": cfg.sliding_window})
        weights = (rnd(G, D, dm, scale=D ** -0.5), rnd(G, D, Dv, scale=D ** -0.5),
                   rnd(G, D, 1, scale=D ** -0.5))
        if B == 1:
            yield ("grouped_matmul_armt_update", "down projection + memory update",
                   (rnd(G, T, F), rnd(G, F, D, scale=F ** -0.5), rnd(G, T, D), *weights,
                    *state(G)), {"M": M, "nu": nu})
        yield ("armt_update", "memory update (B > 1, blocked cells)",
               (rnd(N, M, D), *weights, *state(N)), {"nu": nu})
        lengths = torch.tensor([max(1, T - i * T // slots) for i in range(slots)],
                               dtype=torch.int32, device=device)
        yield ("decode_attention", f"decode, {slots} slots",
               (rnd(slots, Hq, hd), rnd(slots, T, Hkv, hd), rnd(slots, T, Hkv, hd), lengths),
               {"window": cfg.sliding_window})
    elif types == {"mamba"} and cfg.ssm is not None and cfg.armt is None:
        dI, dS, T = cfg.ssm.expand * D, cfg.ssm.d_state, DEFAULT_SEG_LEN
        A_log = torch.log(torch.arange(1, dS + 1, dtype=f32, device=device))

        def scan(n, t, lead):
            return ((rnd(n, t, dI, scale=0.5), rnd(n, t, dI), rnd(n, t, dS, scale=0.5, dtype=f32),
                     rnd(n, t, dS, scale=0.5, dtype=f32), A_log.expand(*lead, dI, dS).contiguous(),
                     torch.ones(*lead, dI, device=device), rnd(n, dI, dS, scale=0.1, dtype=f32)),
                    {"dt_bias": rnd(*lead, dI, scale=0.1, dtype=f32) - 4.6,
                     "z": rnd(n, t, dI, scale=0.5)})
        yield ("mamba_scan", "band scan (fused)", *scan(N, T, (G,)))
        yield ("mamba_scan", f"decode scan, {slots} slots", *scan(slots, 1, ()))
    else:
        raise ValueError(f"{cfg.name}: the main path's shapes are listed for the ARMT attention "
                         "configs and pure-Mamba ones")


def nvidia_smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama-1b-armt")
    ap.add_argument("--cache", help="the dispatch cache file (default: the dispatch layer's)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("tune_kernels: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.autotune import Autotuner, key_shapes
    from repro_torch.serve import MetricsRegistry

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    smi = nvidia_smi()
    dev = torch.device("cuda")
    reg = MetricsRegistry()
    tuner = Autotuner(args.cache, registry=reg)
    print(f"card: {smi}; cache {dispatch.cache_path()}")
    rows = []
    for op, label, a, kw in path_cases(cfg, dev, slots=args.slots, seed=args.seed):
        key = tuner.key_for(op, a)
        rule = dispatch.rule_config(op, key_shapes(op, a))
        cached = dispatch.cached_config(key) is not None
        stored = tuner.get_or_tune(op, a, repeats=args.repeats, op_kwargs=kw)
        rec = tuner.results.get(key)
        row = {"op": op, "label": label, "key": key, "rule": rule.to_json(),
               "stored": stored.to_json(), "cached": cached}
        if cached:
            print(f"{op} [{label}] {key}: cache hit {stored}")
        else:
            winner = rec["winner"] or stored
            row.update(winner=winner.to_json(),
                       ms={json.dumps(c.to_json()): s * 1e3 for c, s in rec["ranked"]},
                       rejected=[c.to_json() for c in rec["rejected"]],
                       dropped=[c.to_json() for c in rec["dropped"]])
            times = "  ".join(f"{c.blocks('block_n', 'block_i', 'block_h') or 'one config'} "
                              f"{s * 1e3:.4f} ms" for c, s in rec["ranked"])
            print(f"{op} [{label}] {key}: {times}; rule {rule.blocks('block_n', 'block_i', 'block_h')}"
                  f", winner {winner.blocks('block_n', 'block_i', 'block_h')}"
                  f"{' (none validated: the heuristic stands)' if rec['winner'] is None else ''}"
                  f", stored {stored.blocks('block_n', 'block_i', 'block_h') or 'the rule'}"
                  f"; rejected {len(rec['rejected'])}, dropped {len(rec['dropped'])} ({smi})")
        rows.append(row)
        del a, kw
        torch.cuda.empty_cache()
    counters = {k: v for k, v in reg.counters.items() if k.startswith("autotune_")}
    print("counters: " + ", ".join(f"{k} {v:g}" for k, v in sorted(counters.items())))
    print(nvidia_smi())
    print(json.dumps({"tune_kernels": {"arch": args.arch, "card": smi, "cases": rows,
                                       "counters": counters}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
