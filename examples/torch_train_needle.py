"""Training on the PyTorch port: an ARMT learns needle-QA where the
retrieval crosses a segment boundary (solvable only through the
associative memory), with checkpoints and resume (``--ckpt-dir``), then
exact-match accuracy under both schedules.

    PYTHONPATH=src python examples/torch_train_needle.py [--steps 600] [--ckpt-dir DIR]
    PYTHONPATH=src python examples/torch_train_needle.py --device cpu

With --full-scale the config is llama-160m-armt (the paper's smallest; for
the card); the default is a 2-layer model of width 64.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import ARMTConfig, get_config, get_smoke_config
from repro_torch.data import needle_qa
from repro_torch.models.model import forward_hidden, last_logits, resolve_device
from repro_torch.optim import OptimConfig
from repro_torch.train.loop import train_loop

SEG = 32


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint here every 100 steps and resume from the latest")
    ap.add_argument("--full-scale", action="store_true",
                    help="llama-160m-armt (the card recommended)")
    ap.add_argument("--eval-batch", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.full_scale:
        cfg = get_config("llama-160m-armt")
        seg = cfg.armt.segment_len
    else:
        cfg = dataclasses.replace(
            get_smoke_config("llama-1b-armt"),
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
            armt=ARMTConfig(segment_len=SEG, num_mem_tokens=8, d_mem=8))
        seg = SEG

    ocfg = OptimConfig(lr=3e-3, total_steps=args.steps, warmup_steps=10, weight_decay=0.0)
    data = needle_qa(cfg.vocab, 32, 4 * seg, seed=0, n_keys=4, needle_region=(0.55, 0.95))

    def log(m):
        print(f"step {m['step']:4d} loss {m['loss']:.4f}", flush=True)

    out = train_loop(cfg, ocfg, data, steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=100, schedule="sequential", log_fn=log, log_every=50,
                     device=device)
    params = out["state"]["params"]

    print("\nexact-match accuracy (chance = 0.25):")
    acc = {}
    for region, name in [((0.80, 0.92), "needle in query segment"),
                         ((0.55, 0.72), "needle in PREVIOUS segment")]:
        test = next(needle_qa(cfg.vocab, args.eval_batch, 4 * seg, seed=999, n_keys=4,
                              needle_region=region))
        toks = torch.as_tensor(test["tokens"]).to(device)
        for sched in ("sequential", "diagonal"):
            with torch.no_grad():
                logits = last_logits(params, cfg, forward_hidden(
                    params, cfg, toks, schedule=sched)[0])
            acc[name, sched] = float((logits.argmax(-1).cpu().numpy()
                                      == test["answer"]).mean())
            print(f"  {name:30s} {sched:10s}: {acc[name, sched]:.3f}")
    return {"history": out["history"], "last_step": out["last_step"], "accuracy": acc}


if __name__ == "__main__":
    main()
