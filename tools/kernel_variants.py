#!/usr/bin/env python3
"""Design checks of the hand-written kernels on one CUDA card: builds
variants of a kernel's CUDA source (each a set of source substitutions)
into libraries of their own and times each beside the source as it
stands, at the main paths' shapes.

    python3 tools/kernel_variants.py [--iters 20] [--sass DIR] [VARIANT ...]

Variants (default: all), by source in ``src/repro_torch/kernels/csrc``:

``flash_attention.cu`` (llama-1b-armt's full-band cell, q [16,1152,32,64],
k/v 8 heads, causal; and the same with hd 128, 24 q heads):

  bkv128      128-key K/V tiles with two consumer warpgroups: half the tiles,
              but the running max moves every 128 keys, so p rounds to bf16
              against other maxima than the unmodified kernel's;
  nwg2        two consumer warpgroups at hd 64 (128-row items) instead of 3;
  pingpong    the consumer warpgroups take turns to issue their products
              (named barriers, FlashAttention-3's ping-pong);
  nooverlap   each tile's PV product waited for before its softmax;
  branchmask  the score mask as `!edge || visible(...)` with an early-return
              visible() per score, as first written.

``mamba_scan.cu`` (falcon-mamba-7b's band step: x [G,1024,8192] bf16,
d_state 16, G groups, at G = 16, 4 and 1, in the TPU kernel's form, dt fp32
and y fp32, and in the fused form the model runs, raw dt, dt_bias and z
in, y gated in bf16):

  small32, small128, nosmall
              blocks of 32 or 128 channels, or of 256 (no small blocks),
              where the grid of 256-channel blocks would leave half the
              SMs or more idle, instead of 64;
  threads128  128-channel blocks instead of 256-channel ones;
  occ4, occ8  512 threads an SM (128 registers) or 1024 (64 registers, 32
              warps) instead of 768 (85);
  tt32        32-token tiles instead of 16;
  expf        the accurate expf of exp(dt A) in place of ex2.approx;
  unroll1     the token loop not unrolled; unroll2: unrolled by 2, not 4;
  probe_*     a part of the scan left out, so the output is wrong and only
              the time is read: nomufu (exp(dt A) replaced by dt A), nobc
              (no B/C reads), nosoftplus (dt + bias used as the step),
              nogate (y z in place of the gate).

For each variant and case it prints the median device time of one launch
(``cardtools.time_ms``), the worst row error against the plain version in
fp32, and how many output elements differ from the unmodified kernel's;
and the registers and spills ptxas reports for the main kernels. With
``--sass DIR`` it writes the SASS of each unmodified library there
(cuobjdump). The last line is a JSON object of every number. Builds go to
``build/kernel_variants/`` (git-ignored). Nothing is gated.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import cardtools

ROOT = cardtools.ROOT
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "kernel_variants"

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
FLASH = {
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

UNROLL = "#pragma unroll 4\n    for (int t = 0; t < cnt; ++t) {"
SCAN = {
    "small32": [("constexpr int SMALL = 64;", "constexpr int SMALL = 32;")],
    "small128": [("constexpr int SMALL = 64;", "constexpr int SMALL = 128;")],
    "nosmall": [("constexpr int SMALL = 64;", "constexpr int SMALL = 256;")],
    "threads128": [("constexpr int THREADS = 256;", "constexpr int THREADS = 128;")],
    "occ4": [("RESIDENT = 768;", "RESIDENT = 512;")],
    "occ8": [("RESIDENT = 768;", "RESIDENT = 1024;")],
    "tt32": [("constexpr int TT = 16;", "constexpr int TT = 32;")],
    "expf": [("ex2_approx(dv * A2[s])", "expf(dv * A2[s] * 0.6931471805599453f)")],
    "unroll1": [(UNROLL, "    for (int t = 0; t < cnt; ++t) {")],
    "unroll2": [(UNROLL, "#pragma unroll 2\n    for (int t = 0; t < cnt; ++t) {")],
    # probes: a part of the scan left out (the output is wrong; only the time is read)
    "probe_nomufu": [("ex2_approx(dv * A2[s])", "(dv * A2[s])")],
    "probe_nobc": [("        const float4 b4 = bt[t * 2 * NG + k], c4 = bt[t * 2 * NG + NG + k];",
                    "        const float4 b4 = make_float4(dv, xv, dv, xv), c4 = b4;")],
    "probe_nosoftplus": [("softplus(to_f(db[t * TH]) + bias)", "(to_f(db[t * TH]) + bias)")],
    "probe_nogate": [("        v = to_f(from_f<TX>(v)) * to_f(from_f<TX>(zf / (1.f + expf(-zf))));",
                      "        v = v * zf;")],
}


def flash_cases(libs, ctx):
    import torch
    from repro_torch.kernels import build, flash_attention as fa
    dev, gen, res = ctx["dev"], ctx["gen"], ctx["results"]
    for shape, (G, T, Hq, Hkv, hd) in [("hd64", (16, 1152, 32, 8, 64)),
                                       ("hd128", (16, 1152, 24, 8, 128))]:
        cell = [torch.randn(G, 1, T, h, hd, generator=gen).to(dev, torch.bfloat16)
                for h in (Hq, Hkv, Hkv)]
        q, k, v = (a.reshape((G,) + a.shape[2:]).transpose(1, 2) for a in cell)
        want = fa.flash_attention_plain(q.float(), k.float(), v.float())
        first = None
        for name, lib in libs.items():
            out = torch.empty(G, T, Hq, hd, dtype=torch.bfloat16, device=dev)

            def call(lib=lib, out=out, name=name):
                build.check(lib.flash_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), G, Hq, Hkv, T, T,
                    hd, *fa._strides(q), *fa._strides(k), *fa._strides(v), 1, 0,
                    float(hd ** -0.5), 1, 1, build.stream_ptr(q)), f"flash variant {name}")
            first = ctx["report"](f"flash {shape} {name}", call,
                                  lambda out=out: out.transpose(1, 2), want, first)
        del cell, q, k, v, want, first


def scan_cases(libs, ctx):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, mamba_scan as ms
    dev, gen = ctx["dev"], ctx["gen"]

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)
    T, dI, dS, lead = 1024, 8192, 16, 256
    for N in (16, 4, 1):
        x = rnd(N, T, dI, scale=0.5)
        raw = rnd(N, T, dI)
        bias = rnd(N, dI, scale=0.1, dtype=torch.float32) - 4.6
        dt = F.softplus(raw.float() + bias[:, None])
        proj = rnd(N, T, lead + 2 * dS, scale=0.5, dtype=torch.float32)
        Bt, Ct = proj[..., lead:lead + dS], proj[..., lead + dS:]
        A_log = torch.log(torch.arange(1, dS + 1, dtype=torch.float32)
                          * (torch.rand(N, dI, dS, generator=gen) + 0.5)).to(dev)
        Dp, h0 = rnd(N, dI, dtype=torch.float32), rnd(N, dI, dS, scale=0.1, dtype=torch.float32)
        zz = rnd(N, T, 2 * dI, scale=0.5)[..., dI:]
        for fused in (False, True):
            d_in, b_in, z_in = (raw, bias, zz) if fused else (dt, None, None)
            want = ms.mamba_scan_plain(x.float(), dt, Bt, Ct, A_log, Dp, h0)[0] \
                if N == 16 and not fused else None
            first = None
            for name, lib in libs.items():
                y = torch.empty(N, T, dI, dtype=torch.bfloat16 if fused else torch.float32,
                                device=dev)
                hT = torch.empty(N, dI, dS, device=dev)

                def call(lib=lib, y=y, hT=hT, d_in=d_in, b_in=b_in, z_in=z_in, name=name):
                    build.check(lib.mamba_scan_launch(
                        x.data_ptr(), d_in.data_ptr(), Bt.data_ptr(), Ct.data_ptr(),
                        A_log.data_ptr(), Dp.data_ptr(), h0.data_ptr(),
                        None if b_in is None else b_in.data_ptr(),
                        None if z_in is None else z_in.data_ptr(), y.data_ptr(), hT.data_ptr(),
                        None, ms.CHUNK, N, T, dI, dS, N, *ms._strides(x), *ms._strides(d_in),
                        *ms._strides(Bt), *ms._strides(Ct),
                        *(ms._strides(z_in) if z_in is not None else (0, 0)),
                        1, 0, 0, build.stream_ptr(x)), f"scan variant {name}")
                first = ctx["report"](f"scan G={N} {'fused' if fused else 'unfused'} {name}",
                                      call, lambda y=y: y, want, first)
            del want, first
        del x, raw, bias, dt, proj, Bt, Ct, A_log, Dp, h0, zz


# source -> (entry point, variants, helpers prepended to the anonymous
# namespace, the main kernels' names for ptxas, the cases)
SOURCES = {
    "flash_attention.cu": ("flash_attention_launch", FLASH, HELPERS, re.compile(r"flash_wgmma"),
                           flash_cases),
    "mamba_scan.cu": ("mamba_scan_launch", SCAN, "",
                      re.compile(r"mamba_scan_kernelILi\d+E13__nv_bfloat16Li16ELb\dE"),
                      scan_cases),
}


def variant_source(cu: str, name: str) -> str:
    _, variants, helpers, _, _ = SOURCES[cu]
    src = (CSRC / cu).read_text()
    for old, new in variants.get(name, []):
        if old not in src:
            raise SystemExit(f"variant {name}: {cu} no longer contains {old[:60]!r}")
        src = src.replace(old, new)
    return src.replace("namespace {\n", "namespace {\n" + helpers, 1) if helpers else src


def registers(log: str, main: re.Pattern) -> dict:
    """{kernel: (registers, spill store bytes)} of the main kernels."""
    out = {}
    for e in re.split(r"Compiling entry function '", log)[1:]:
        name = e.split("'", 1)[0]
        used = re.search(r"Used (\d+) registers", e)
        spill = re.search(r"(\d+) bytes spill stores", e)
        if main.search(name) and used:
            out[name[:80]] = (int(used.group(1)), int(spill.group(1)) if spill else 0)
    return out


def main() -> int:
    every = {v: cu for cu, s in SOURCES.items() for v in s[1]}
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sass", type=Path, help="write the unmodified kernels' SASS here")
    ap.add_argument("variants", nargs="*", default=list(every))
    args = ap.parse_args()
    unknown = [v for v in args.variants if v not in every]
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {', '.join(every)}")
    import torch
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    jobs = {}   # (source, variant) for every library to build, "kernel" unmodified
    for v in args.variants:
        jobs[(every[v], "kernel")] = None
        jobs[(every[v], v)] = None
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for cu, name in jobs:
        stem = Path(cu).stem
        src = OUT / f"{stem}_{name}.cu"
        src.write_text(variant_source(cu, name))
        so = OUT / f"lib_{stem}_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-shared",
               str(src), "-o", str(so)]
        procs[(cu, name)] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True))
    libs, regs = {cu: {} for cu in SOURCES}, {}
    for (cu, name), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{cu} {name}: build failed\n{log[-3000:]}", flush=True)
            continue
        entry, _, _, main_re, _ = SOURCES[cu]
        lib = ctypes.CDLL(str(so))
        getattr(lib, entry).argtypes = build.SIGNATURES[entry]
        getattr(lib, entry).restype = ctypes.c_int
        libs[cu][name] = lib
        regs[f"{Path(cu).stem} {name}"] = registers(log, main_re)
        if args.sass is not None and name == "kernel":
            args.sass.mkdir(parents=True, exist_ok=True)
            sass = subprocess.run(["cuobjdump", "-sass", str(so)], capture_output=True, text=True)
            (args.sass / f"{Path(cu).stem}.sass").write_text(sass.stdout + sass.stderr)
    smi, _ = cardtools.card()
    print(f"card: {smi} (name, power limit W, max SM MHz)", flush=True)
    results = {"card": smi, "registers": regs}

    def report(key, call, output, want, first):
        """Times one variant's call on a case; returns the first output seen
        (the unmodified kernel's), against which later ones are counted."""
        call()
        torch.cuda.synchronize()
        got = output().float()
        first = got if first is None else first
        r = {"ms": cardtools.time_ms(call, args.iters), "differing": int((got != first).sum())}
        line = (f"  {key:34s} {r['ms']:.4f} ms  elements differing from the kernel's "
                f"{r['differing']}")
        if want is not None:
            r["worst_row_rel"] = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
            line += f"  worst row rel err {r['worst_row_rel']:.2e}"
        results[key] = r
        print(line, flush=True)
        return first

    ctx = {"dev": torch.device("cuda"), "gen": torch.Generator().manual_seed(0),
           "results": results, "report": report}
    for cu, found in libs.items():
        if found:
            SOURCES[cu][4](found, ctx)
    for name, r in regs.items():
        print(f"  ptxas {name}: " + ", ".join(f"{k} {u} registers, {s} B spilled"
                                            for k, (u, s) in sorted(r.items())), flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
