#!/usr/bin/env python3
"""Where the time of llama-1b-armt's three schedules goes, on one CUDA card.

    python3 tools/profile_schedules.py [--src DIR] [--tokens 16384 131072]
                                       [--cache-rows 131136] [--trace-dir DIR]

Draws random bf16 weights at full width and depth (seed 0) and, for each
prompt length in ``--tokens`` (B = 1), traces one run of each of the
paper's three schedules, all on the port's kernels, after a warm-up:

  full        forward_hidden(mode="full", schedule="sequential"): one
              segment of the whole prompt, no memory (the full-attention
              baseline)
  sequential  forward_hidden(schedule="sequential"): the fused cell one
              (segment, layer) at a time (sequential ARMT), each segment a
              replay of one captured CUDA graph; "sequential eager" the
              same uncaptured
  diagonal    forward_hidden(schedule="diagonal"): the fused cell over the
              anti-diagonal bands (diagonal batching)

then decode as ``ServeEngine`` runs it, each step of its ``DecodeProgram``
a CUDA graph replay ("graph") or the same step uncaptured ("eager"): one
cache-mode step (B = 1) over a full KV cache of ``--cache-rows`` rows, and
``--decode-steps`` ARMT steps at B = 1. For each it prints the wall time
(host clock ending in a synchronize; also of one run without the
profiler), the summed device time of every kernel and copy, the device's
idle share (1 - device / wall), the device time by kind (flash attention,
the grouped GEMM and cuBLAS, the ARMT memory kernels, decode attention,
copies, PyTorch's elementwise and indexing kernels) and the kernels with
the most device time, and last one JSON line. Nothing is gated. ``--src``
imports ``repro_torch`` from another tree (one with ``DecodeProgram``).

    python3 tools/profile_schedules.py --serve [--serve-runs 2]

profiles ``serve`` instead: chip_smoke's phase (e) requests (6 prompts of
1-3 segments and a tail, 4 slots, chunk 8, greedy) at blocking admission
(k = 0), the default interleaved k = 4, k = 4 with ``fused_admission`` and
k = -1. Per setting, from an instrumented ``ContinuousScheduler`` (its
rounds and chunks wrapped, host clock): wall and tok/s, admission rounds
and their host time, the host time to enqueue the decode chunks and the
time waiting for each chunk's tokens, slot-chunks decoding, reserved by
an admission in flight and free, the pooled band steps, and the round
work's device span (CUDA events around each round); then one traced run
(``profile``): device time, idle share, device time by kind.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from cardtools import profile

ROOT = Path(__file__).resolve().parent.parent

# device time by kind of kernel, from the kernel's name (first match wins)
KINDS = [("flash", ("flash_wgmma", "flash_simt")),
         ("decode", ("decode_partial", "decode_combine")),
         ("armt", ("armt_",)),
         ("gemm", ("gmm_", "gemm", "xmma", "nvjet", "cutlass", "cublas")),
         ("copy", ("copy_kernel", "CatArrayBatchedCopy", "Memcpy", "Memset")),
         ("elementwise", ("elementwise", "vectorized", "reduce_kernel", "fill_kernel",
                          "index", "scatter"))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="directory holding the repro_torch package to profile")
    ap.add_argument("--tokens", type=int, nargs="+", default=[16384, 131072])
    ap.add_argument("--cache-rows", type=int, default=131136)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace-dir", type=Path, default=None,
                    help="write gzipped Chrome traces here")
    ap.add_argument("--serve", action="store_true",
                    help="profile serve's admission settings instead")
    ap.add_argument("--serve-runs", type=int, default=2,
                    help="instrumented runs per serve setting, alternating")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_schedules: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cfg = get_config("llama-1b-armt")
    params = M.init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)

    def sync():
        torch.cuda.synchronize(dev)

    def run(tk, **kw):
        @torch.no_grad()
        def fn():
            h, _ = M.forward_hidden(params, cfg, tk, **kw)
            M.last_logits(params, cfg, h)
        return fn

    out = {"src": str(args.src), "card": smi}
    if args.serve:
        out["serve"] = serve_profile(params, cfg, rng, sync, args)
        print(json.dumps(out))
        return 0
    for n_tok in args.tokens:
        tk = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n_tok))).to(dev)
        for label, kw in [("full", dict(mode="full", schedule="sequential")),
                          ("sequential", dict(schedule="sequential")),
                          ("sequential eager", dict(schedule="sequential", eager=True)),
                          ("diagonal", dict(schedule="diagonal"))]:
            fn = run(tk, **kw)
            fn()
            sync()
            out[f"{label} {n_tok}"] = profile(f"{label} {n_tok}", fn, sync, KINDS,
                                              args.trace_dir, args.top, "schedules")
            torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, eager in (("graph", False), ("eager", True)):
        prog = ServeEngine(params, cfg, serve_mode="cache", max_len=args.cache_rows,
                           eager=eager).program(1)
        prog.prepare()
        for k in ("k", "v"):
            prog.state["pattern"][0][k].normal_(generator=gen)
        prog.state["pos"].fill_(args.cache_rows - 1)
        step = torch.no_grad()(prog.step)
        step()
        sync()
        name = f"cache decode step {args.cache_rows} {label}"
        out[name] = profile(name, step, sync, KINDS, args.trace_dir, args.top, "schedules")
        del prog, step
        torch.cuda.empty_cache()
        prog = ServeEngine(params, cfg, eager=eager).program(1)
        prog.prepare()

        @torch.no_grad()
        def steps():
            for _ in range(args.decode_steps):
                prog.step()
        steps()
        sync()
        name = f"ARMT decode {args.decode_steps} steps B=1 {label}"
        out[name] = profile(name, steps, sync, KINDS, args.trace_dir, args.top, "schedules")
        del prog
    print(json.dumps(out))
    return 0


SERVE_SETTINGS = {"k=0 (blocking)": dict(prefill_groups_per_chunk=0),
                  "k=4 (default)": {},
                  "k=4 fused": dict(fused_admission=True),
                  "k=-1": dict(prefill_groups_per_chunk=-1)}


def serve_profile(params, cfg, rng, sync, args) -> dict:
    """Phase (e)'s serve at each admission setting: where a run's host and
    device time go (see the module docstring)."""
    import time

    import torch
    from repro_torch.core import diagonal as D
    from repro_torch.serve import ContinuousScheduler, Request, ServeEngine

    engine = ServeEngine(params, cfg)
    seg = engine.seg_len
    spec = [(1, 1000, 40), (2, 990, 64), (3, 1010, 24), (1, 300, 48), (2, 980, 56),
            (1, 10, 32)]
    reqs = [Request(i, rng.integers(0, cfg.vocab, n * seg + tail), new)
            for i, (n, tail, new) in enumerate(spec)]
    n_tok = sum(r.max_new for r in reqs)

    def instrumented(kw):
        sched = ContinuousScheduler(engine, n_slots=4, chunk=8, **kw)
        st = dict(rounds=0, round_host_s=0.0, round_device_ms=0.0, chunks=0,
                  chunk_enqueue_s=0.0, chunk_wait_s=0.0, slot_chunks_decoding=0,
                  slot_chunks_reserved=0, slot_chunks_free=0)
        events = []
        adv, run_chunk, drain = (sched._advance_admissions, sched._run_chunk,
                                 sched._drain_chunk)

        def advance():
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            out = adv()
            b.record()
            st["round_host_s"] += time.perf_counter() - t0
            st["rounds"] += 1
            events.append((a, b))
            return out

        def chunk():
            active = sum(s.active for s in sched.slots)
            st["slot_chunks_decoding"] += active
            st["slot_chunks_reserved"] += len(sched._adms)
            st["slot_chunks_free"] += sched.n_slots - active - len(sched._adms)
            t0 = time.perf_counter()
            out = run_chunk()
            st["chunk_enqueue_s"] += time.perf_counter() - t0
            st["chunks"] += 1
            return out

        def drained(toks, active):
            t0 = time.perf_counter()
            gen = drain(toks, active)
            first = next(gen, None)         # the chunk's one device-to-host read
            st["chunk_wait_s"] += time.perf_counter() - t0
            if first is not None:
                yield first
                yield from gen

        sched._advance_admissions, sched._run_chunk, sched._drain_chunk = (
            advance, chunk, drained)
        return sched, st, events

    @torch.no_grad()
    def one(kw):
        sched, st, events = instrumented(kw)
        D.pool_counts.update(steps=0, member_steps=0)
        t0 = time.perf_counter()
        n = sum(1 for _ in sched.run(reqs))
        sync()
        st["wall_s"] = time.perf_counter() - t0
        st["tok_s"] = n / st["wall_s"]
        st["round_device_ms"] = sum(a.elapsed_time(b) for a, b in events)
        st["pooled_band_steps"] = dict(D.pool_counts)
        st["idle_drain_rounds"] = sched.idle_drain_rounds
        assert n == n_tok, (n, n_tok)
        return st

    for kw in SERVE_SETTINGS.values():         # warm-up: captures and first launches
        one(kw)
    out = {label: [] for label in SERVE_SETTINGS}
    order = list(SERVE_SETTINGS.items())
    for r in range(args.serve_runs):
        for label, kw in (order if r % 2 == 0 else order[::-1]):
            st = one(kw)
            out[label].append(st)
            print(f"== serve {label}, run {r + 1}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in st.items()), flush=True)
    for label, kw in SERVE_SETTINGS.items():
        def fn(kw=kw):
            with torch.no_grad():
                for _ in engine.serve(reqs, n_slots=4, chunk=8, **kw):
                    pass
        out[label].append(profile(f"serve {label}", fn, sync, KINDS, args.trace_dir,
                                  args.top, "serve"))
    return out


if __name__ == "__main__":
    sys.exit(main())
