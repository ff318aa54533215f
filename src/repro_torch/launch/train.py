"""Training driver: ``python -m repro_torch.launch.train --arch <id>``.

Drives the fault-tolerant loop (``train/loop.py``) on a synthetic stream
(``data/synthetic.py``: the Markov LM stream or the needle task) with
checkpoints, on the card by default; ``--smoke`` takes the reduced config
of the same family and ``--device cpu`` runs on the CPU (the tests).

    python -m repro_torch.launch.train --arch llama-1b-armt --steps 12 \\
        --seq-len 16384 --batch 1 --schedule diagonal --task lm
    python -m repro_torch.launch.train --arch llama-1b-armt --smoke --device cpu
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--schedule", default="auto", choices=["auto", "diagonal", "sequential"])
    ap.add_argument("--task", default="needle", choices=["needle", "lm"])
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of the same family (CPU-sized)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import lm_stream, needle_qa
    from repro_torch.optim import OptimConfig
    from repro_torch.train.loop import train_loop

    cfg = (get_smoke_config(args.arch, seq_len=args.seq_len) if args.smoke
           else get_config(args.arch))
    ocfg = OptimConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(10, args.steps // 20))
    gen = needle_qa if args.task == "needle" else lm_stream
    data = gen(cfg.vocab, args.batch, args.seq_len, seed=args.seed)

    def log(m):
        print(f"step {m['step']:5d} loss {m['loss']:.4f} gnorm {m['grad_norm']:.2f} "
              f"lr {m['lr']:.2e} dt {m['step_time_s']:.2f}s", flush=True)

    out = train_loop(cfg, ocfg, data, steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, schedule=args.schedule,
                     microbatches=args.microbatches, log_fn=log, log_every=10,
                     seed=args.seed, device=args.device)
    last = out["history"][-1]["loss"] if out["history"] else float("nan")
    print(f"done at step {out['last_step']}; final loss {last:.4f}")
    return out


if __name__ == "__main__":
    main()
