"""Captured programs: the port of the reference's jitted, donated loops.

A ``Program`` runs a function of no arguments over static buffers, tensors
that keep their addresses for the program's life and that the function
reads and updates in place (the counterpart of a donated state). On a CUDA
device it is a CUDA graph: when the Program is made it warms the function
up on a side stream (the kernels' build, the libcuda entry point,
shared-memory attributes and cuBLAS workspaces happen there) and captures
it; every call replays the graph. With ``capture=False`` (the CPU always,
or an eager run on the card to hold against the graph) each call runs the
function itself.

The kernels' launch counters (``kernels.build.launch_counts``) are Python
globals that the wrappers bump when they launch, which under a graph
happens only while capturing. So a Program takes back what the warm-up and
the capture counted and adds the capture's count on every replay: the
counters read the same under graphs as eager.

What the captured function returns lives in the graph's memory pool and is
overwritten by the next replay; copy out what is kept. Warm-up runs the
function for real, so make a Program before its static buffers hold live
data.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import torch

from repro_torch.kernels import build

WARMUP = 2   # warm-up runs before a capture

# CUDA graphs this process captured, and the host seconds their warm-ups and
# captures took (the telemetry's ``graph_captures`` probe reads them)
captures = 0
capture_seconds = 0.0


@contextlib.contextmanager
def uncounted():
    """Launches counted inside the block are taken back when it ends; the
    yielded dict receives them, {(module, counter name): launches}."""
    before = build.launch_counts()
    counted: Dict = {}
    try:
        yield counted
    finally:
        for key, n in build.launch_counts().items():
            was = before.get(key, 0)
            if n != was:
                counted[key] = n - was
                setattr(key[0], key[1], was)


def add_counts(counted: Dict) -> None:
    """Adds a recorded count ({(module, counter name): launches}) to the
    counters, as a replay launches it."""
    for (module, name), n in counted.items():
        setattr(module, name, getattr(module, name) + n)


class Program:
    """fn() over static buffers, run as a CUDA graph or eagerly.

    capture: True captures a CUDA graph now (a CUDA device only: the CPU
    never captures) and every call replays it; a failed capture raises.
    False runs fn at every call."""

    def __init__(self, fn: Callable, device, *, capture: bool):
        device = torch.device(device)
        if capture and device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        self.fn, self.graph, self.out = fn, None, None
        self.launches: Dict = {}     # what one replay launches
        if capture:
            self._capture(device)

    def __call__(self):
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        add_counts(self.launches)
        return self.out

    def _capture(self, device) -> None:
        global captures, capture_seconds
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with uncounted(), torch.cuda.stream(side):
            for _ in range(WARMUP):
                self.fn()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with uncounted() as self.launches, torch.cuda.graph(graph):
            self.out = self.fn()
        self.graph, self.fn = graph, None        # the graph holds what it needs
        torch.cuda.synchronize(device)
        captures += 1
        capture_seconds += time.perf_counter() - t0
