"""Fault-tolerant training loop.

Auto-resume from the latest checkpoint, periodic keep-k checkpoints
(atomic, written in the background), a final checkpoint on SIGTERM or
SIGINT, non-finite step skipping (inside the train step), a step-time
watchdog for stragglers, and the deterministic data stream fast-forwarded
from the step counter on resume. Each step's metrics are journaled to
``<ckpt_dir>/metrics.jsonl``.
"""
from __future__ import annotations

import json
import signal
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ArchConfig
from repro_torch.data import to_device
from repro_torch.models.model import resolve_device
from repro_torch.optim import OptimConfig
from repro_torch.train.state import init_train_state, make_train_step


class Watchdog:
    """Flags steps longer than ``factor`` x the median of the last 50 (a
    straggler or a hang), from the sixth step on."""

    def __init__(self, factor: float = 3.0):
        self.times = []
        self.factor = factor

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) < 5:
            return False
        return dt > self.factor * float(np.median(self.times[-50:]))


def train_loop(cfg: ArchConfig, ocfg: OptimConfig, data: Iterator[Dict], *, steps: int,
               ckpt_dir: Optional[str] = None, schedule: str = "auto",
               mode: str = "segmented", microbatches: int = 1, ckpt_every: int = 100,
               log_every: int = 10, seed: int = 0,
               log_fn: Optional[Callable[[Dict], None]] = None, resume: bool = True,
               device=None, keep: int = 3, generator=None) -> Dict:
    """Trains to step ``steps`` -> {"state", "history" (each step's metrics
    as floats, with "step" and "step_time_s"), "last_step"}. The state
    starts from ``init_train_state`` with ``generator`` (default: a CPU
    generator seeded ``seed``, the same weights on every device; a
    generator on the card draws there, much faster at full size), or, with
    ``ckpt_dir`` and ``resume``, from its latest checkpoint, the data
    stream then skipping the steps already taken. keep: the checkpoints
    kept. device None means the card (it raises without one)."""
    device = resolve_device(device)
    step_fn = make_train_step(cfg, ocfg, schedule=schedule, mode=mode,
                              microbatches=microbatches)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    state = init_train_state(cfg, ocfg, generator, device=device)

    mgr = CheckpointManager(ckpt_dir, keep=keep) if ckpt_dir else None
    start_step = 0
    if mgr and resume and mgr.latest_step() is not None:
        start_step = mgr.latest_step()
        state = mgr.restore(state, start_step)
        print(f"[train] resumed from step {start_step}", flush=True)

    stop = {"flag": False}

    def on_signal(sig, frame):
        stop["flag"] = True

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, on_signal)
        except ValueError:
            pass   # not the main thread

    wd = Watchdog()
    history = []
    log_path = Path(ckpt_dir) / "metrics.jsonl" if ckpt_dir else None
    it = iter(data)
    for _ in range(start_step):     # the deterministic stream, fast-forwarded
        next(it)

    step, saved = start_step - 1, start_step
    try:
        for step in range(start_step, steps):
            batch = next(it)
            batch.pop("answer", None)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, to_device(batch, device))
            metrics = {k: float(v) for k, v in metrics.items()}   # waits for the step
            dt = time.perf_counter() - t0
            metrics.update(step=step, step_time_s=dt)
            if wd.observe(dt):
                metrics["straggler"] = True
                print(f"[watchdog] step {step} took {dt:.2f}s (>{wd.factor}x median)",
                      flush=True)
            history.append(metrics)
            if log_path:
                with open(log_path, "a") as f:
                    f.write(json.dumps(metrics) + "\n")
            if log_fn and step % log_every == 0:
                log_fn(metrics)
            if mgr and (step + 1) % ckpt_every == 0:
                mgr.save(step + 1, state)
                saved = step + 1
            if stop["flag"]:
                print(f"[train] preemption signal at step {step}; checkpointing and "
                      "exiting", flush=True)
                break
    finally:
        if mgr:
            if saved != step + 1:
                mgr.save(step + 1, state, block=True)
            mgr.wait()
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
    return {"state": state, "history": history, "last_step": step + 1}
