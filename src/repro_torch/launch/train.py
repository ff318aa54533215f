"""Training driver: ``python -m repro_torch.launch.train --arch <id>``.

Drives the fault-tolerant loop (``train/loop.py``) on a synthetic stream
(``data/synthetic.py``: the Markov LM stream or the needle task) with
checkpoints, on the card by default; ``--smoke`` takes the reduced config
of the same family and ``--device cpu`` runs on the CPU (the tests).

``--distributed`` trains on a mesh over ``torch.distributed``
(``train_loop(mesh=)``): every process joins the group from ``torchrun``'s
environment (``launch/mesh.py`` ``init_distributed``; NCCL, one rank a GPU,
or ``--dist-backend gloo``) and cuts ``--mesh AXES`` (``parse_mesh``'s
grammar, as ``serve --mesh``; default ``data`` over every rank). The rank
at coordinate 0 prints and writes the checkpoints, which hold the whole
state.

    python -m repro_torch.launch.train --arch llama-1b-armt --steps 12 \\
        --seq-len 16384 --batch 1 --schedule diagonal --task lm
    python -m repro_torch.launch.train --arch llama-1b-armt --smoke --device cpu
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch llama-1b-armt \\
        --smoke --device cpu --distributed --mesh data=2,model=2 --dist-backend gloo
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
    ap.add_argument("--distributed", action="store_true",
                    help="train on a mesh over torch.distributed (torchrun's environment)")
    ap.add_argument("--mesh", default=None, metavar="AXES",
                    help="with --distributed: a comma list of axis[=size] (e.g. "
                         "data=2,model=2; default: data over every rank)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="the process group's backend with --distributed (default: nccl "
                         "with a GPU, else gloo)")
    args = ap.parse_args(argv)
    if args.mesh is not None and not args.distributed:
        ap.error("--mesh needs --distributed")

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import lm_stream, needle_qa
    from repro_torch.optim import OptimConfig
    from repro_torch.train.loop import train_loop

    mesh, say = None, print
    if args.distributed:
        from repro_torch.launch.mesh import init_distributed, parse_mesh
        backend = init_distributed(args.dist_backend)
        try:
            mesh = parse_mesh(args.mesh or "data")
        except ValueError as e:
            raise SystemExit(f"train: --mesh: {e}") from None
        if any(mesh.coords.values()):
            def say(*a, **k):
                pass
        say(f"mesh: {mesh.shape} over {mesh.size} rank(s) ({backend})")

    cfg = (get_smoke_config(args.arch, seq_len=args.seq_len) if args.smoke
           else get_config(args.arch))
    ocfg = OptimConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(10, args.steps // 20))
    gen = needle_qa if args.task == "needle" else lm_stream
    data = gen(cfg.vocab, args.batch, args.seq_len, seed=args.seed)

    def log(m):
        say(f"step {m['step']:5d} loss {m['loss']:.4f} gnorm {m['grad_norm']:.2f} "
              f"lr {m['lr']:.2e} dt {m['step_time_s']:.2f}s", flush=True)

    out = train_loop(cfg, ocfg, data, steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, schedule=args.schedule,
                     microbatches=args.microbatches, log_fn=log, log_every=10,
                     seed=args.seed, device=args.device, mesh=mesh)
    last = out["history"][-1]["loss"] if out["history"] else float("nan")
    say(f"done at step {out['last_step']}; final loss {last:.4f}")
    return out


if __name__ == "__main__":
    main()
