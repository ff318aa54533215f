"""What the measuring tools in this directory share, on one CUDA card.

- ``tree_args`` / ``use_tree``: the ``--src DIR`` option (import
  ``repro_torch`` from another tree, a parent commit unpacked beside this
  one say, so one call measures both) and ``--iters``; with
  ``outputs=True`` also ``--outputs FILE`` and ``--against FILE``.
- ``card``: the card's name, power limit and maximum SM clock
  (``nvidia-smi``), and the exponentials a second its special-function
  units reach at that clock.
- ``time_ms``: the median device time of one call, by CUDA events behind
  a ~0.5 ms spin of the card (``torch.cuda._sleep``), so the host has
  enqueued the whole call before the start event and its Python time is
  not counted.
- ``kernels``: the device kernels of one call, by name, with their
  launches per call and median durations (torch.profiler).
- ``Outputs``: saves named outputs for ``--outputs`` and counts the
  elements that differ, bit for bit, from another run's ``--against``.
- ``profile``: one traced run of a function (torch.profiler, CPU and CUDA
  activity): wall time (also unprofiled), summed device time, the
  device's idle share, the device time by kind of kernel and the kernels
  with the most device time; optionally a gzipped Chrome trace.

The rates below are the H100 SXM's: bf16 989 TFLOP/s dense, fp32 67
TFLOP/s, 3.35 TB/s of HBM, 132 SMs, 16 exponentials a clock per SM.
"""
from __future__ import annotations

import gzip
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PEAK_BF16, PEAK_FP32, PEAK_BYTES, N_SM, SFU_PER_CLOCK_SM = 989e12, 67e12, 3.35e12, 132, 16


def tree_args(ap, outputs: bool = False):
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="directory holding the repro_torch package to measure")
    ap.add_argument("--iters", type=int, default=20)
    if outputs:
        ap.add_argument("--outputs", type=Path,
                        help="save the compared outputs to this file (torch.save)")
        ap.add_argument("--against", type=Path,
                        help="count the output elements that differ from those saved in "
                             "this file (another tree's --outputs)")
    return ap


def use_tree(args) -> None:
    """Makes ``import repro_torch`` take the package under ``args.src``."""
    sys.path.insert(0, str(args.src.resolve()))


def card() -> tuple[str, float]:
    """("name, power limit W, max SM MHz", exponentials per second)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    return smi, SFU_PER_CLOCK_SM * N_SM * float(smi.split(",")[-1]) * 1e6


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import numpy as np
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def kernels(fn, iters: int = 20) -> dict:
    """{kernel name: (launches per call, median ms)} over ``iters`` calls."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by = {}
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            by.setdefault(ev.name, []).append(ev.device_time)
    return {k: (len(v) / iters, float(np.median(v)) / 1e3) for k, v in by.items()}


class Outputs:
    """Named outputs of one run, saved for ``--outputs`` and compared bit for
    bit with ``--against``'s."""

    def __init__(self, args):
        import torch
        self.path = getattr(args, "outputs", None)
        against = getattr(args, "against", None)
        self.against = against
        self.saved = torch.load(against) if against else None
        self.kept = {}

    def keep(self, name, out):
        """Keeps out (a tensor, or a tuple whose first item is kept); returns
        how many of its elements differ from --against's, or None."""
        out = (out[0] if isinstance(out, tuple) else out).cpu()
        self.kept[name] = out
        if self.saved is None or name not in self.saved:
            return None
        diff = int((out != self.saved[name]).sum().item())
        print(f"  {name}: {diff} of {out.numel()} output elements differ from {self.against}",
              flush=True)
        return diff

    def save(self):
        import torch
        if self.path:
            torch.save(self.kept, self.path)


# a CUPTI record of the host waiting on a full launch queue, not device work
QUEUE_FULL = "Command Buffer Full"


def kind(name: str, kinds) -> str:
    """The first kind in ``kinds`` ([(kind, (name fragment, ...)), ...])
    whose fragment the kernel's name holds, else "other"."""
    low = name.lower()
    for k, keys in kinds:
        if any(key.lower() in low for key in keys):
            return k
    return "other"


def profile(label, fn, sync, kinds, trace_dir=None, top: int = 15, prefix: str = "trace"):
    """One unprofiled and one traced run of fn; prints and returns wall,
    device time, idle share (1 - device / wall), time the host was blocked
    on a full launch queue, device time by kind and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    t0 = time.perf_counter()
    fn()
    sync()
    unprofiled = time.perf_counter() - t0
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    # device-side records only (kernels, copies, memsets): the CPU ops'
    # device totals would count their kernels twice
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    blocked = sum(us for k, us, _ in rows if k == QUEUE_FULL) / 1e6
    rows = sorted((r for r in rows if r[0] != QUEUE_FULL and r[1] > 0), key=lambda r: -r[1])
    device = sum(us for _, us, _ in rows) / 1e6
    print(f"== {label}: wall {wall:.4f} s ({unprofiled:.4f} s unprofiled), device "
          f"{device:.4f} s, idle share {1 - device / wall:.3f}; host blocked on a full "
          f"launch queue {blocked:.4f} s", flush=True)
    split = {}
    for key, us, count in rows:
        ms, n = split.get(kind(key, kinds), (0.0, 0))
        split[kind(key, kinds)] = (ms + us / 1e3, n + count)
    print("  by kind: " + "; ".join(f"{k} {ms:.3f} ms ({100 * ms / 1e3 / device:.1f} %, "
                                    f"{n} launches)" for k, (ms, n) in sorted(split.items())))
    for key, us, count in rows[:top]:
        print(f"  {us / 1e3:10.3f} ms  {100 * us / 1e6 / wall:5.1f} % of wall  "
              f"{count:6d} x  {key[:100]}")
    if trace_dir is not None:
        trace_dir.mkdir(parents=True, exist_ok=True)
        path = trace_dir / f"{prefix}_{label.replace(' ', '_')}.json"
        prof.export_chrome_trace(str(path))
        with open(path, "rb") as f, gzip.open(f"{path}.gz", "wb") as g:
            shutil.copyfileobj(f, g)
        path.unlink()
    return {"wall_s": wall, "unprofiled_wall_s": unprofiled, "device_s": device,
            "idle_share": 1 - device / wall,
            "queue_full_s": blocked,
            "by_kind": {k: {"ms": ms, "launches": n} for k, (ms, n) in split.items()},
            "top": [{"kernel": k[:100], "ms": us / 1e3, "count": c} for k, us, c in rows[:top]]}
