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

The rates below are the H100 SXM's: bf16 989 TFLOP/s dense, fp32 67
TFLOP/s, 3.35 TB/s of HBM, 132 SMs, 16 exponentials a clock per SM.
"""
from __future__ import annotations

import subprocess
import sys
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
