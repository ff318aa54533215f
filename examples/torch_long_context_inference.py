"""Long-context serving on the PyTorch port (the paper's deployment
scenario): batched long prompts served with the diagonal-batching prefill
and constant-memory ARMT decode. Compares, on one model:

  * the sequential and the diagonal prefill's wall time (paper Tables 1/9);
  * the ARMT decode state's bytes against a full-attention KV cache's at
    the same context (paper Fig. 1), from their shapes on the meta device.

    PYTHONPATH=src python examples/torch_long_context_inference.py [--long]
    PYTHONPATH=src python examples/torch_long_context_inference.py --device cpu
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import ARMTConfig, get_smoke_config
from repro_torch.models.model import decode_state_shapes, init_params, resolve_device
from repro_torch.serve import ServeEngine
from repro_torch.utils import Timer, fmt_bytes, tree_bytes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--long", action="store_true", help="16k-token prompts (slower)")
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="prompt tokens (default 4096, 16384 with --long)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    seg = 128
    cfg = dataclasses.replace(
        get_smoke_config("llama-1b-armt"),
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
        max_position=1 << 17,
        armt=ARMTConfig(segment_len=seg, num_mem_tokens=8, d_mem=8))
    params = init_params(cfg, 0, device=device)
    P = args.prompt_len or (16384 if args.long else 4096)
    prompts = np.random.default_rng(1).integers(8, cfg.vocab, (args.batch, P))
    print(f"model: {cfg.n_layers}L d={cfg.d_model}; prompt {P} tokens "
          f"({P // seg} segments of {seg}); batch {args.batch}")

    out = {}
    for sched in ("sequential", "diagonal"):
        eng = ServeEngine(params, cfg, serve_mode="armt", schedule=sched,
                          max_len=P + args.max_new, device=device)
        with Timer() as t:
            res = eng.generate(prompts, args.max_new)
        out[sched] = {"s": t.s, "tokens": res.tokens}
        print(f"  {sched:10s} prefill+decode: {t.s:7.2f}s tokens={res.tokens.shape}")

    # memory: the ARMT state against a full-attention KV cache at this context
    a = tree_bytes(decode_state_shapes(cfg, args.batch, serve_mode="armt", max_len=P,
                                       dtype=torch.float32))
    k = tree_bytes(decode_state_shapes(cfg, args.batch, serve_mode="cache", max_len=P,
                                       dtype=torch.float32))
    print(f"decode state: ARMT {fmt_bytes(a)} vs full KV {fmt_bytes(k)} "
          f"({k / a:.1f}x saving; grows with context for KV, constant for ARMT)")
    out.update(armt_bytes=a, kv_bytes=k)
    return out


if __name__ == "__main__":
    main()
