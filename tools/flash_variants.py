#!/usr/bin/env python3
"""Design checks of the flash kernel on one CUDA card: builds variants of
``src/repro_torch/kernels/csrc/flash_attention.cu`` (each a set of source
substitutions) into their own libraries and times each beside the kernel
as it stands, at llama-1b-armt's main shape and with hd 128.

    python3 tools/flash_variants.py [--iters 20] [VARIANT ...]

Variants (default: all):

  bkv128      128-key K/V tiles with two consumer warpgroups: half the tiles,
              but the running max moves every 128 keys, so p rounds to bf16
              against other maxima than the previous kernel's;
  nwg2        two consumer warpgroups at hd 64 (128-row items) instead of 3;
  pingpong    the consumer warpgroups take turns to issue their products
              (named barriers, FlashAttention-3's ping-pong);
  nooverlap   each tile's PV product waited for before its softmax;
  branchmask  the score mask as `!edge || visible(...)` with an early-return
              visible() per score, as first written.

For each it prints the median device time of one launch (CUDA events
behind a ~0.5 ms spin of the card), the worst row error against the plain
version in fp32, and how many output elements differ from the unmodified
kernel's. The last line is a JSON object of every number. Builds go to
``build/flash_variants/`` (git-ignored). Nothing is gated.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "flash_variants"

TILE0 = ("        wgmma_fence();\n        issue_s(s, ring + stage * C::STAGE);\n"
         "        wgmma_wait<0>();")
LOOP = ("        fence_operands<HD, BKV>(o, p);\n        wgmma_fence();\n"
        "        issue_s(s, ring + stage * C::STAGE);\n"
        "        mma_pv<HD>(o, p, ring + prev * C::STAGE + C::KV_BYTES);\n"
        "        wgmma_commit();")
LAST = ("      fence_operands<HD, BKV>(o, p);\n      wgmma_fence();\n"
        "      mma_pv<HD>(o, p, ring + prev * C::STAGE + C::KV_BYTES);\n      wgmma_commit();")
MASK = '''      if (edge) {   // warp-uniform: one branch a tile, a select per score
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          const int row = rowA + ((i >> 1) & 1) * 8;
          const int col = kv0 + 8 * (i >> 2) + (lane % 4) * 2 + (i & 1);
          s[i] = visible(row, col, S, causal, window) ? s[i] : -CUDART_INF_F;
        }
      }
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) s[i] *= scale_log2;'''
HELPERS = '''
__device__ __forceinline__ void pp_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void pp_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ bool visible_branchy(int row, int col, int S, int causal, int window) {
  if (col >= S) return false;
  if (causal && col > row) return false;
  if (window > 0) {
    if (col <= row - window) return false;
    if (!causal && col >= row + window) return false;
  }
  return true;
}
'''
SYNC, ARRIVE = "pp_sync(1 + wg, 2 * WG_THREADS);", "pp_arrive(1 + (wg + 1) % NWG, 2 * WG_THREADS);"
VARIANTS = {
    "bkv128": [("static constexpr int BKV = 64;", "static constexpr int BKV = 128;"),
               ("static constexpr int NWG = HD == 64 ? 3 : 2;", "static constexpr int NWG = 2;"),
               ("wgmma_ss_m64n64k16_bf16<0>(s, da, db, kk > 0);",
                "wgmma_ss_m64n128k16_bf16<0>(s, da, db, kk > 0);")],
    "nwg2": [("static constexpr int NWG = HD == 64 ? 3 : 2;", "static constexpr int NWG = 2;")],
    "pingpong": [
        ("  const int tid = threadIdx.x % WG_THREADS, warp = tid / 32, lane = tid % 32;\n",
         "  const int tid = threadIdx.x % WG_THREADS, warp = tid / 32, lane = tid % 32;\n"
         "  if (wg == NWG - 1) pp_arrive(1, 2 * WG_THREADS);\n"),
        (TILE0, "        " + SYNC + "\n" + TILE0.replace("wgmma_wait<0>();", ARRIVE + "\n        wgmma_wait<0>();")),
        (LOOP, "        " + SYNC + "\n" + LOOP + "\n        " + ARRIVE),
        (LAST, "      " + SYNC + "\n" + LAST + "\n      " + ARRIVE),
        ("    }\n  }\n}\n\nconstexpr int SIMT_ROWS",
         "    }\n  }\n  if (wg == 0) pp_sync(1, 2 * WG_THREADS);\n}\n\nconstexpr int SIMT_ROWS")],
    "nooverlap": [("wgmma_wait<1>();   // S is done, PV may still run", "wgmma_wait<0>();")],
    "branchmask": [(MASK, '''#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int row = rowA + ((i >> 1) & 1) * 8;
        const int col = kv0 + 8 * (i >> 2) + (lane % 4) * 2 + (i & 1);
        s[i] = !edge || visible_branchy(row, col, S, causal, window) ? s[i] * scale_log2
                                                                     : -CUDART_INF_F;
      }''')],
}


def variant_source(name: str) -> str:
    src = (CSRC / "flash_attention.cu").read_text()
    for old, new in VARIANTS.get(name, []):
        if old not in src:
            raise SystemExit(f"variant {name}: the source no longer contains {old[:60]!r}")
        src = src.replace(old, new)
    return src.replace("namespace {\n", "namespace {\n" + HELPERS, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args()
    import numpy as np
    import torch
    from repro_torch.kernels import build, flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 2
    names = ["kernel"] + [v for v in args.variants if v != "kernel"]
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = OUT / f"flash_{name}.cu"
        cu.write_text(variant_source(name))
        so = OUT / f"lib_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(CSRC), "-shared", str(cu), "-o", str(so)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: build failed\n{log}", flush=True)
            continue
        lib = ctypes.CDLL(str(so))
        lib.flash_attention_launch.argtypes = build.SIGNATURES["flash_attention_launch"]
        lib.flash_attention_launch.restype = ctypes.c_int
        libs[name] = lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def time_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(args.iters):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))

    results = {"card": smi}
    for shape, (G, T, Hq, Hkv, hd) in [("hd64", (16, 1152, 32, 8, 64)),
                                       ("hd128", (16, 1152, 24, 8, 128))]:
        cell = [torch.randn(G, 1, T, h, hd, generator=gen).to(dev, torch.bfloat16)
                for h in (Hq, Hkv, Hkv)]
        q, k, v = (a.reshape((G,) + a.shape[2:]).transpose(1, 2) for a in cell)
        want = fa.flash_attention_plain(q.float(), k.float(), v.float())
        first = None
        for name, lib in libs.items():
            out = torch.empty(G, T, Hq, hd, dtype=torch.bfloat16, device=dev)

            def call(lib=lib, out=out):
                code = lib.flash_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), G, Hq, Hkv, T, T,
                    hd, *fa._strides(q), *fa._strides(k), *fa._strides(v), 1, 0,
                    float(hd ** -0.5), 1, 1, build.stream_ptr(q))
                build.check(code, f"flash variant {name}")
            call()
            torch.cuda.synchronize()
            got = out.transpose(1, 2).float()
            err = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
            first = got if first is None else first
            diff = int((got != first).sum().item())
            ms = time_ms(call)
            results[f"{shape} {name}"] = dict(ms=ms, worst_row_rel=err, differing=diff)
            print(f"  {shape} {name:11s} {ms:.4f} ms  worst row rel {err:.2e}  elements "
                  f"differing from the kernel's {diff}", flush=True)
        del cell, q, k, v, want, first
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
