"""Quickstart on the PyTorch port: build a small ARMT, run both schedules
and check they agree, train a few steps, generate.

    PYTHONPATH=src python examples/torch_quickstart.py              # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import ARMTConfig, get_smoke_config
from repro_torch.data import lm_stream
from repro_torch.models.model import forward_hidden, init_params, resolve_device
from repro_torch.optim import OptimConfig
from repro_torch.serve import ServeEngine
from repro_torch.train.loop import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. a small ARMT (the paper's Llama-ARMT family), fp32
    cfg = dataclasses.replace(
        get_smoke_config("llama-1b-armt"),
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
        armt=ARMTConfig(segment_len=32, num_mem_tokens=8, d_mem=8))
    params = init_params(cfg, 0, device=device)
    toks = torch.randint(8, cfg.vocab, (2, 128), generator=torch.Generator().manual_seed(1))
    toks = toks.to(device)

    # 2. the paper's claim: diagonal batching is a pure reordering
    with torch.no_grad():
        h_seq, _ = forward_hidden(params, cfg, toks, schedule="sequential")
        h_diag, _ = forward_hidden(params, cfg, toks, schedule="diagonal")
    diff = float((h_seq - h_diag).abs().max())
    print(f"schedules agree: max|diff| = {diff:.2e}")

    # 3. train a few steps (the fault-tolerant loop, non-finite skip, AdamW)
    ocfg = OptimConfig(lr=3e-3, total_steps=args.steps, warmup_steps=2)
    out = train_loop(cfg, ocfg, lm_stream(cfg.vocab, 4, 128), steps=args.steps,
                     schedule="auto", device=device)
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    print(f"loss: {first:.3f} -> {last:.3f}")

    # 4. serve: diagonal prefill + constant-memory ARMT decode
    eng = ServeEngine(out["state"]["params"], cfg, serve_mode="armt", schedule="diagonal",
                      max_len=256, device=device)
    res = eng.generate(toks.cpu().numpy(), max_new=8)
    print(f"generated {res.tokens.shape} tokens (prefill segments: {res.prefill_segments})")
    print("ok")
    return {"max_diff": diff, "loss": (first, last), "tokens": res.tokens}


if __name__ == "__main__":
    main()
