"""The serving entry point: ``python -m repro_torch.launch.serve --arch <id>``.

Two modes, as the reference's ``launch/serve.py``:

  * single (default): one batch of ``--batch`` prompts of ``--prompt-len``
    tokens through ``ServeEngine.generate``: the diagonal (or sequential)
    prefill, then decode against the constant-size ARMT state (greedy, or
    sampled on the device with ``--temperature``/``--top-k``). With
    ``--session-store`` it runs a two-turn session: turn 2 resumes from
    the stored end of turn 1 and feeds only its new tokens.
  * ``--continuous``: ``--requests`` requests of two prompt lengths
    through ``ServeEngine.serve``, the continuous-batching scheduler;
    tokens stream back per request. Rejections arrive as ``RequestError``
    events on the same stream and are printed. With ``--prefix-cache`` the
    requests share a system prompt, and an admission whose prefix is
    cached transplants the stored boundary state.

The weights are random, drawn from ``--seed`` by a generator on the
serving device (``init_params(cfg, torch.Generator(device).manual_seed(
seed), device=device)``): the card's numbers differ from the CPU's. The
prompts are drawn on the host with numpy, so the card and the CPU get the
same token ids: ``--continuous`` draws the reference CLI's requests
exactly (``np.random.default_rng(seed + 1)``, the two length buckets, the
shared system prompt); the single-mode batch comes from
``default_rng(seed + 1)`` and a session's second turn from
``default_rng(seed + 2)``.

Observability: ``--trace-out`` writes the chunk-granular span timeline
(Chrome-trace JSON, schema-checked on export), ``--metrics`` /
``--metrics-out`` the engine's ``metrics_snapshot()`` (with
``program_counts``, the decode programs and CUDA graphs, where the
reference has jit-compile counts), and ``--profile-dir`` a
``torch.profiler`` trace (the CPU, and the card's kernels on the card)
whose ``record_function`` spans line up with the engine's timeline.

Both modes take ``--mesh AXES`` (``launch/mesh.py`` ``parse_mesh``: e.g.
``data=2,model=2``, ``data,model=1``) for mesh-native serving over
``torch.distributed``: the params are cut to each rank's blocks, the cells
run tensor-parallel over 'model', the batch (or the slots) splits over
'data', and over 'stage' each rank holds one block of L / stage
consecutive layers, the diagonal prefill running as a pipeline across the
stages and decode as a chain of hand-offs, the last stage's output
broadcast to every rank (``ServeEngine(mesh=...)``; where 'stage' does not
divide the layers every stage rank runs them all, with the sharding
rules' fallback warning). Under ``torchrun`` each rank joins the
group from its environment (NCCL, one rank a GPU; ``--dist-backend gloo``
for several ranks on one card, CUDA tensors staged through host memory);
without it the process is a group of one. Every rank draws the same
weights and requests; only rank 0 prints (and writes the trace and
metrics). With an axis of more than one rank decode runs eager (no CUDA
graphs).

    torchrun --nproc-per-node 8 -m repro_torch.launch.serve --arch llama-1b-armt \\
        --mesh data=2,model=4 --prompt-len 16384 --batch 2
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch llama-1b-armt \\
        --mesh stage=2 --dist-backend gloo --prompt-len 16384 --max-new 32

Runs on the card unless ``--device cpu`` is given; ``--smoke`` takes the
reduced config of the same family. Where the engine refuses a run (an
encoder config, which needs frame embeddings the CLI has none of; a
pure-SSM model's prefix cache at a ``max_len`` other than its segment),
the CLI exits non-zero with the engine's one-line reason.

    python -m repro_torch.launch.serve --arch llama-1b-armt --prompt-len 16384 \\
        --batch 1 --max-new 64
    python -m repro_torch.launch.serve --arch llama-1b-armt --smoke --device cpu \\
        --continuous --prefix-cache

``main(argv)`` returns what was generated (see its docstring).
"""
from __future__ import annotations

import argparse
import json
import os
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of the same family (CPU-sized)")
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--serve-mode", default="armt", choices=["armt", "cache"])
    ap.add_argument("--schedule", default="diagonal", choices=["diagonal", "sequential"])
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 samples on the device")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over --requests requests")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=None,
                    help="push model: drain the source into a backlog of at most this many "
                         "requests and reject (a queue_full event) beyond it; default the "
                         "pull model (requests pulled between chunks)")
    ap.add_argument("--prefill-groups-per-chunk", type=int, default=4,
                    help="interleaved admission: an admission's diagonal prefill advances "
                         "this many band steps per decode chunk; -1 a whole stage; 0 "
                         "blocking admission")
    ap.add_argument("--fused-admission", action="store_true",
                    help="enqueue each round's band steps right after its decode chunk, "
                         "before the chunk's tokens are read")
    ap.add_argument("--max-concurrent-admissions", type=int, default=None,
                    help="admissions in flight at once (default: as many as free slots; "
                         "1: one at a time)")
    ap.add_argument("--admission-fairness", default="round_robin",
                    choices=["round_robin", "oldest_first"])
    ap.add_argument("--prefix-cache", action="store_true",
                    help="segment-granular prefix cache: the requests share a system "
                         "prompt; admission transplants the cached boundary state")
    ap.add_argument("--prefix-cache-mb", type=float, default=64.0,
                    help="prefix-cache LRU byte budget")
    ap.add_argument("--session-store", action="store_true",
                    help="two-turn session: turn 2 resumes from the stored end of turn 1")
    ap.add_argument("--session-mb", type=float, default=128.0)
    ap.add_argument("--store-dir", default=None,
                    help="disk-spill directory for evicted store entries")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the run's span timeline as Chrome-trace JSON")
    ap.add_argument("--metrics", action="store_true",
                    help="print the engine's metrics snapshot as JSON after the run")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics snapshot JSON to a file")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the run into this directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    ap.add_argument("--mesh", default=None, metavar="AXES",
                    help="mesh-native serving over torch.distributed: a comma list of "
                         "axis[=size] over {pod,data,model,stage} (at most one size may be "
                         "omitted), e.g. data=2,model=2 or stage=2; params shard over "
                         "'model', the batch and slots over 'data', the layers over 'stage' "
                         "(one block of consecutive layers a rank, run as a pipeline)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="the process group's backend with --mesh (default: nccl with a "
                         "CUDA device, else gloo); gloo runs several ranks on one card")
    return ap


def continuous_requests(cfg, *, prompt_len: int, n_requests: int, max_new: int, seed: int,
                        prefix_cache: bool):
    """The reference CLI's ``--continuous`` requests, drawn with its numpy
    calls: alternating prompts of ``prompt_len`` and ``prompt_len + seg //
    2`` tokens (seg the ARMT segment, else 64), ids in [8, vocab); with a
    prefix cache each begins with one shared system prompt of whole
    segments."""
    import numpy as np

    from repro_torch.serve import Request

    seg = cfg.armt.segment_len if cfg.armt else 64
    rng = np.random.default_rng(seed + 1)
    lens = [prompt_len if i % 2 == 0 else max(1, prompt_len + seg // 2)
            for i in range(n_requests)]
    if not prefix_cache:
        return [Request(req_id=f"r{i}",
                        prompt=rng.integers(8, cfg.vocab, (L,)).astype("int32"),
                        max_new=max_new)
                for i, L in enumerate(lens)]
    n_sys = max(seg, (prompt_len // (2 * seg)) * seg)
    sys_prompt = rng.integers(8, cfg.vocab, (n_sys,)).astype("int32")
    return [Request(req_id=f"r{i}",
                    prompt=np.concatenate([
                        sys_prompt,
                        rng.integers(8, cfg.vocab, (max(1, L - n_sys),)).astype("int32")]),
                    max_new=max_new)
            for i, L in enumerate(lens)]


def main(argv=None):
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``) and return what it
    generated, a dict with ``mode``, ``arch``, ``n_params`` (the elements of
    the params it built) and ``wall_s``, and per mode:

      * "single": ``prompts`` [B, P] and ``tokens`` [B, max_new] (numpy),
        ``ttft_s``, ``tok_s``, ``finite``, ``prefill_segments``;
      * "session": ``prompts`` [[1, P], [1, P2]], ``tokens`` (each turn's
        [1, max_new]), ``resumed`` (turn 2's), ``ttft_s`` (both turns);
      * "continuous": ``requests`` (the ``Request``s), ``streams`` {req_id:
        [tokens]}, ``errors`` (the ``RequestError``s), ``done`` {req_id:
        (ttft_s, tok_s)}, ``n_tokens``, ``prefix_cache`` (its stats, or
        None).

    Exits (SystemExit) on a refused run or an invalid trace."""
    ap = _parser()
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.model import init_params, resolve_device
    from repro_torch.serve import (PrefixCache, RequestError, ServeEngine, SessionStore,
                                   Telemetry, validate_chrome_trace)
    from repro_torch.utils import tree_params

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.continuous and (args.temperature > 0 or args.top_k > 0):
        ap.error("--continuous streams greedy tokens; --temperature/--top-k "
                 "apply to single-batch mode only")
    mesh, say = None, print
    if args.mesh is not None:
        from repro_torch.launch.mesh import init_distributed, parse_mesh
        backend = init_distributed(args.dist_backend)
        try:
            mesh = parse_mesh(args.mesh)
        except ValueError as e:
            raise SystemExit(f"serve: --mesh: {e}") from None
        if mesh.rank != 0:
            def say(*a, **k):
                pass
    device = resolve_device(args.device)
    if mesh is not None:
        say(f"mesh: {mesh.shape} over {mesh.size} {device.type} device(s) ({backend})")

    def refused(err: Exception):
        return SystemExit(f"serve: {cfg.name}: refused: {err}")

    params = init_params(cfg, torch.Generator(device=device).manual_seed(args.seed),
                         device=device)
    n_params = tree_params(params)
    seg = cfg.armt.segment_len if cfg.armt else 64
    prefix_cache = (PrefixCache(seg, max_bytes=int(args.prefix_cache_mb * 2**20),
                                spill_dir=args.store_dir)
                    if args.prefix_cache else None)
    session_store = (SessionStore(max_bytes=int(args.session_mb * 2**20),
                                  spill_dir=args.store_dir)
                     if args.session_store else None)
    tel = Telemetry(trace=args.trace_out is not None)
    try:
        # headroom for the longer of the two continuous prompt lengths
        eng = ServeEngine(params, cfg, serve_mode=args.serve_mode, schedule=args.schedule,
                          device=device, max_len=args.prompt_len + seg // 2 + args.max_new,
                          prefix_cache=prefix_cache, session_store=session_store,
                          telemetry=tel, mesh=mesh,
                          eager=mesh is not None and max(mesh.shape.values()) > 1)
    except ValueError as e:
        raise refused(e) from None
    out = {"arch": cfg.name, "n_params": n_params}

    prof = None
    if args.profile_dir and say is print:     # rank 0 profiles
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()

    def epilogue():
        """The profile, then --trace-out / --metrics[-out], in both modes."""
        if say is not print:     # ranks other than 0 write nothing
            return out
        if prof is not None:
            prof.stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            path = os.path.join(args.profile_dir, "trace.json")
            prof.export_chrome_trace(path)
            say(f"torch profile -> {path}")
        if args.trace_out:
            tel.trace.export(args.trace_out)
            errs = validate_chrome_trace(args.trace_out)
            if errs:
                raise SystemExit(f"trace schema check failed: {errs}")
            say(f"trace: {len(tel.trace.spans)} spans -> {args.trace_out}")
        if args.metrics or args.metrics_out:
            snap = eng.metrics_snapshot()
            if args.metrics:
                say("metrics:", json.dumps(snap, indent=2, default=str))
            if args.metrics_out:
                with open(args.metrics_out, "w") as f:
                    json.dump(snap, f, indent=2, default=str)
                say(f"metrics -> {args.metrics_out}")
        return out

    if args.continuous:
        reqs = continuous_requests(cfg, prompt_len=args.prompt_len,
                                   n_requests=args.requests, max_new=args.max_new,
                                   seed=args.seed, prefix_cache=prefix_cache is not None)
        t0 = time.perf_counter()
        n_tok = 0
        outs = {r.req_id: [] for r in reqs}
        errors, done = [], {}
        try:
            events = eng.serve(
                reqs, n_slots=args.slots, chunk=args.chunk, max_queue=args.max_queue,
                prefill_groups_per_chunk=args.prefill_groups_per_chunk,
                fused_admission=args.fused_admission,
                max_concurrent_admissions=args.max_concurrent_admissions,
                admission_fairness=args.admission_fairness)
        except ValueError as e:
            raise refused(e) from None
        for ev in events:
            if isinstance(ev, RequestError):
                errors.append(ev)
                say(f"{ev.req_id}: REJECTED [{ev.code}] {ev.message}")
                continue
            n_tok += 1
            outs[ev.req_id].append(ev.token)
            if ev.done:
                done[ev.req_id] = (ev.ttft_s, ev.tok_s)
                say(f"{ev.req_id}: done ({ev.index + 1} tokens, ttft={ev.ttft_s:.2f}s, "
                      f"{ev.tok_s:.1f} tok/s) first 8: {outs[ev.req_id][:8]}")
        dt = time.perf_counter() - t0
        k, n_conc = args.prefill_groups_per_chunk, args.max_concurrent_admissions
        adm = ("blocking" if k == 0 else
               "blocking(whole stage per advance)" if k < 0
               else f"interleaved(k={k}, N={'slots' if n_conc is None else n_conc}, "
                    f"{args.admission_fairness}{', fused' if args.fused_admission else ''})")
        say(f"arch={cfg.name} mode={args.serve_mode} slots={args.slots} "
              f"requests={args.requests} admission={adm}")
        say(f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s)")
        stats = None
        if prefix_cache is not None:
            stats = prefix_cache.stats.as_dict()
            say(f"prefix-cache: {stats['hits']} hits / {stats['misses']} misses, "
                  f"{len(prefix_cache)} entries, {stats['bytes_in_ram'] / 2**10:.1f} KiB, "
                  f"{stats['evictions']} evictions ({stats['spills']} spilled)")
        out.update(mode="continuous", requests=reqs, streams=outs, errors=errors, done=done,
                   n_tokens=n_tok, wall_s=dt, prefix_cache=stats)
        return epilogue()

    prompts = np.random.default_rng(args.seed + 1).integers(
        8, cfg.vocab, (args.batch, args.prompt_len))
    if session_store is not None:
        # two-turn session on row 0: turn 2 feeds only its new tokens
        turn2 = np.random.default_rng(args.seed + 2).integers(
            8, cfg.vocab, (1, max(8, seg // 2)))
        t0 = time.perf_counter()
        try:
            r1 = eng.generate(prompts[:1], args.max_new, session_id="demo")
            r2 = eng.generate(turn2, args.max_new, session_id="demo")
        except ValueError as e:
            raise refused(e) from None
        dt = time.perf_counter() - t0
        say(f"arch={cfg.name} session demo: turn1 ttft={r1.ttft_s:.2f}s "
              f"({prompts.shape[1]} prompt tokens), turn2 resumed={r2.resumed} "
              f"ttft={r2.ttft_s:.2f}s ({turn2.shape[1]} new tokens, history never "
              "recomputed)")
        say("turn2 first 8:", r2.tokens[0, :8].tolist())
        out.update(mode="session", prompts=[prompts[:1], turn2],
                   tokens=[r1.tokens, r2.tokens], resumed=r2.resumed,
                   ttft_s=[r1.ttft_s, r2.ttft_s], wall_s=dt)
        return epilogue()

    t0 = time.perf_counter()
    try:
        res = eng.generate(prompts, args.max_new, temperature=args.temperature,
                           top_k=args.top_k, seed=args.seed)
    except ValueError as e:
        raise refused(e) from None
    dt = time.perf_counter() - t0
    say(f"arch={cfg.name} mode={args.serve_mode} schedule={args.schedule} "
          f"prefill_segments={res.prefill_segments}")
    say(f"generated {res.tokens.shape} tokens in {dt:.2f}s "
          f"(ttft={res.ttft_s:.2f}s, decode {res.tok_s:.1f} tok/s)")
    say("first row:", res.tokens[0].tolist())
    out.update(mode="single", prompts=prompts, tokens=res.tokens, ttft_s=res.ttft_s,
               tok_s=res.tok_s, finite=res.finite, prefill_segments=res.prefill_segments,
               wall_s=dt)
    return epilogue()


if __name__ == "__main__":
    main()
