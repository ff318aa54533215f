"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc`` process
(all started together), then linked into one shared library with a plain C
interface, loaded with ``ctypes``. The build happens at first use, into
``build/kernels/<hash of the sources>/`` at the repository root (ignored by
git), and is reused while the sources are unchanged. A failed build raises.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception.

Each kernel wrapper module counts its launches in module globals, which it
names here with ``count_launches`` when it is imported; ``launch_counts``
reads them all (``core/capture.py`` replays what a captured program
launched).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the entry points (the launches return cudaError_t as int,
# the two queries the choice they were asked for)
SIGNATURES = {
    # x, w, bias, res, out, G, R, K, N, x group and row strides, res group
    # and row strides, weight batch, layer index (int32 [G] or null),
    # weight groups (w's leading dim), dtype (0 f32, 1 bf16), out_f32, act
    # (0 none, 1 silu, 2 gelu), route (1 TMA + wgmma, 0 SIMT), BN (128, 256,
    # 0: choose_bn's), stream
    "gmm_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L,
                   _I, _P, _I, _I, _I, _I, _I, _I, _P],
    # a query, not a launch: choose_bn's BN for G, R, N, out_f32, read
    "gmm_choose_bn": [_I, _I, _I, _I, _I],
    # q, k, v, out, N, Hq, Hkv, T, S, hd, q strides (n, h, t),
    # k strides (n, h, s), v strides (n, h, s), causal, window, scale, dtype,
    # route (1 TMA + wgmma, 0 SIMT), stream
    "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _L, _L, _L, _L, _L, _L, _L, _L, _L,
                               _I, _I, _F, _I, _I, _P],
    # read, fp32: q (x Wq), A, z, out, N, T, dm, P, Dv, stream
    "armt_read_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # read, bf16, its splits: q, A, z, Phi, W, den, N, T, dm, P, Dv,
    # Phi and W row strides, stream
    "armt_read_split_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _P],
    # read, bf16, the three-term product: Phi, W, den, out, N, T, P, Dv,
    # Phi and W row strides, BN (128, 256, 0: choose_bn's), stream
    "armt_read_gemm_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _P],
    # q, k, v, lengths (int32), out, partial o and (m, l) workspaces (fp32),
    # B, Hq, Hkv, S, hd, q strides (b, h), k strides (b, s, h), v strides
    # (b, s, h), window, scale, chunk, splits, q heads a block, dtype, stream
    "decode_attention_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _L, _L, _L, _L, _L, _L, _L, _L, _I, _F, _I, _I, _I, _I, _P],
    # k, v (fp32 projections), m (memory rows), wb, A, z, A_out, z_out,
    # phi scratch, aux scratch, N, M, dm, P, phi row stride, Dv, D,
    # m strides (n, row), weight batch, dtype, stream
    "armt_update_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _L, _L, _I, _I, _P],
    # x, dt, B, C, A_log, D, h0, dt_bias (or null), z (or null), y, hT, the
    # kept states (or null), their chunk, N, T, dI, dS, G, x strides (n, t),
    # dt strides (n, t), B strides (n, t), C strides (n, t), z strides
    # (n, t), dtype, dt_bias dtype, a block's channels (64, 256, 0: the
    # kernel's rule), stream
    "mamba_scan_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _I, _I, _P],
    # a query, not a launch: the block's channels at 0 for N rows of dI
    "mamba_scan_choose_block": [_I, _I],
    # the scan's backward: x, dt, B, C, A_log, D, dt_bias (or null), z (or
    # null), dy, the kept states, dhT (or null), dx, ddt, dz (or null), the
    # blocks' dB/dC partials, per-row dA_log, dD, d dt_bias (or null), dh0,
    # scratch, N, T, dI, dS, G, chunk, the block and sub-chunk the buffers
    # were sized by, dtype, dt_bias dtype, stream
    "mamba_scan_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}

# module name -> (module, counter names), for every kernel wrapper module
_COUNTED: dict = {}

_lib = None
build_seconds = None   # wall time of the build this process ran (None: reused)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _build(out_dir: Path) -> Path:
    cus, headers = _sources()
    nvcc = _nvcc()
    tmp = out_dir.with_name(out_dir.name + f".tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for cu in cus:
        obj = tmp / (cu.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(cu), "-o", str(obj)]
        procs.append((cu, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    for cu, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {cu.name}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {cu.name}:\n{out}")
    so = tmp / "librepro_kernels.so"
    link = [nvcc, "-shared", "-o", str(so), *[str(o) for _, o, _ in procs]]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
    (tmp / "ptxas.log").write_text("\n".join(logs))
    if out_dir.exists():          # another process finished the same build
        shutil.rmtree(tmp)
    else:
        os.replace(tmp, out_dir)
    return out_dir / "librepro_kernels.so"


def source_hash() -> str:
    h = hashlib.sha256()
    cus, headers = _sources()
    for f in cus + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    out_dir = BUILD_ROOT / source_hash()
    so = out_dir / "librepro_kernels.so"
    if not so.exists():
        t0 = time.perf_counter()
        so = _build(out_dir)
        build_seconds = time.perf_counter() - t0
    handle = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = handle
    return _lib


def loaded() -> bool:
    """Whether this process has loaded the kernel library."""
    return _lib is not None


def ptxas_log() -> str:
    """What ``ptxas -v`` said of each kernel in the current build."""
    path = BUILD_ROOT / source_hash() / "ptxas.log"
    return path.read_text() if path.exists() else ""


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def count_launches(module, *names: str) -> None:
    """Declares launch counters of a kernel wrapper module: globals of
    ``module`` that its wrappers add one to where they launch a kernel."""
    _COUNTED[module.__name__] = (module, names)


def launch_counts() -> dict:
    """{(module, counter name): value} of every declared launch counter."""
    return {(m, n): getattr(m, n) for m, names in _COUNTED.values() for n in names}
