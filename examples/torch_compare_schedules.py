"""Schedule comparison on the PyTorch port, any assigned architecture at
its reduced size: the schedules' equivalence (paper §4.5), their wall
times (paper §4.3), and the serialization argument counted as run: the
sequential schedule takes S*L steps of one (segment, layer) cell each, the
diagonal one S+L-1 band steps (paper Lemma 3.1). The cells every step ran
are recorded (``core.schedule.recording_cells``), and each schedule is
checked as a valid order of the grid (``validate_schedule``) and for
minimality (``is_minimal``).

    PYTHONPATH=src python examples/torch_compare_schedules.py --arch jamba-1.5-large-398b
    PYTHONPATH=src python examples/torch_compare_schedules.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_smoke_config
from repro_torch.core.schedule import is_minimal, recording_cells, validate_schedule
from repro_torch.models.model import forward_hidden, init_params, resolve_device
from repro_torch.utils import Timer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b", choices=ASSIGNED_ARCHS)
    ap.add_argument("--n-seg", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    params = init_params(cfg, 0, device=device)
    seg = cfg.armt.segment_len if cfg.armt else 16
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(8, cfg.vocab, (2, args.n_seg * seg), generator=gen).to(device)
    kw = {} if cfg.armt else {"seg_len": seg}
    if cfg.encoder is not None:
        kw["enc_frames"] = torch.randn(2, cfg.encoder.n_frames, cfg.d_model,
                                       generator=gen).to(device)
    L = cfg.n_layers

    outs = {}
    for sched in ("sequential", "diagonal"):
        with torch.no_grad():
            # eager: the sequential schedule runs each cell from Python (on
            # the card it would otherwise replay a captured segment), so
            # every cell is recorded
            with recording_cells() as runs:
                h, _ = forward_hidden(params, cfg, toks, schedule=sched, eager=True, **kw)
            with Timer() as t:
                forward_hidden(params, cfg, toks, schedule=sched, **kw)
        (groups,) = runs
        validate_schedule(groups, args.n_seg, L)
        steps, minimal = len(groups), is_minimal(groups, args.n_seg, L)
        outs[sched] = {"h": h, "s": t.s, "steps": steps, "minimal": minimal,
                       "cells": sum(len(g) for g in groups)}
        print(f"{args.arch} [{sched:10s}]  {t.s:6.3f}s   steps: {steps:4d} "
              f"({sum(len(g) for g in groups)} cells; valid, minimal={minimal})")

    d = float((outs["sequential"]["h"] - outs["diagonal"]["h"]).abs().max())
    print(f"max |sequential - diagonal| = {d:.3e} (the same recurrence)")
    print(f"steps: sequential {outs['sequential']['steps']} = S*L, diagonal "
          f"{outs['diagonal']['steps']} = S+L-1 ({args.n_seg} segments x {L} layers); "
          f"speedup diagonal vs sequential: {outs['sequential']['s'] / outs['diagonal']['s']:.2f}x")
    for o in outs.values():
        del o["h"]
    return {"max_diff": d, **outs}


if __name__ == "__main__":
    main()
