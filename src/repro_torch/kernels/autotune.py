"""Kernel autotuner: sweeps the configs each kernel compiles, validates the
fastest and stores it in the dispatch cache.

The port of the reference's autotuner. ``Autotuner.get_or_tune`` returns
the cached winner of an op's (backend, shape bucket, dtype) key, or sweeps
the op's config space with paired timing (every candidate visited in each
round, so drift hits all alike), validates the candidates fastest first
and stores the first that passes (``dispatch.store_config``). Later
processes resolve straight to it through the disk cache. Sweeps happen only
here, never inside ``dispatch.resolve``.

A winner is timed and validated at one exact shape but serves its whole
bucket, so it is stored relative to the kernel's own rule
(``dispatch.rule_relative``): a block that equals the rule's pick at the
tuned shape is stored as 0, and every shape of the bucket then runs its own
rule's pick; only a block that beat the rule carries its value over. A
cached block that a shape of the bucket cannot run (decode's heads a block
above the call's q heads a kv head) is refused at resolve, never launched
(``dispatch.check_fits``).

Config spaces (``config_space``) hold only what the kernels compile:

* ``cuda``: ``block_n`` 128 or 256 for the GEMM (``grouped_matmul``, the
  fused update's GEMM) and armt_read's bf16 product; ``block_i`` 64 or 256
  for ``mamba_scan``; for ``decode_attention`` each ``block_h`` that
  divides the q heads of a kv head (at most 1,024 outputs a block).
  ``flash_attention`` and ``armt_update`` have one config each. The plain
  version never competes on the card: the reference lets its XLA lowering
  compete, but on the card a plain winner would be a fallback hiding the
  kernel.
* ``cpu``: the plain version alone; there is nothing to tune.
* ``test``: the ``cuda`` space with ``impl="plain"``: on the CPU, the
  sweep, validation and cache machinery run with each candidate the plain
  version under a distinct config (the reference's ``interpret``).

Validation (``validate``), two checks, a candidate kept only if it passes
both:

1. run on fp32 copies of the operands, it agrees with the plain version on
   them within the reference's ``atol=2e-4, rtol=2e-3`` (on the card the
   fp32 copies take the kernels' fp32 routes, where the GEMM has no column
   tile: for ``block_n`` the second check carries the weight);
2. run on the operands as given, its output equals the heuristic config's
   to the bit: the card checks pin bits (diagonal = sequential, graph =
   eager, the serve CLI = the engine), so a winner must not move one. Each
   config of the card's space is expected to be bit-neutral (a GEMM output
   element's k order, a scan channel's thread and a decode head's sums do
   not depend on the tile); the check decides.

Registry counters (the serve stack's default registry, or one passed in):

* ``autotune_sweep_total{op}``: timed candidate launches;
* ``autotune_cache_hit_total{op}``: ``get_or_tune`` calls served from the
  cache (a warm cache makes no sweep launch at all);
* ``autotune_validate_total{op,result}``: validations, ``pass`` or ``fail``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import dispatch, ops, ref
from repro_torch.kernels.decode_attention import MAX_GROUP_WIDTH
from repro_torch.kernels.dispatch import KernelConfig

ATOL, RTOL = 2e-4, 2e-3     # the reference's validation tolerance
SPIN = 1_000_000            # cycles the card spins before a timed call (~0.5 ms)


# ---------------------------------------------------------------------------
# Config spaces
# ---------------------------------------------------------------------------

def _blocks(op: str, shapes) -> List[Dict[str, int]]:
    if op in ("grouped_matmul", "grouped_matmul_armt_update", "armt_read"):
        return [{"block_n": bn} for bn in (128, 256)]
    if op == "mamba_scan":
        return [{"block_i": b} for b in (64, 256)]
    if op == "decode_attention":
        if shapes is None:
            return [{}]
        (_, Hq, hd), Hkv = tuple(shapes[0]), tuple(shapes[1])[2]
        rep = Hq // Hkv
        return [{"block_h": h} for h in range(1, rep + 1)
                if rep % h == 0 and h * hd <= MAX_GROUP_WIDTH]
    if op in ("flash_attention", "armt_update"):
        return [{}]
    raise ValueError(f"unknown op {op!r}")


def config_space(op: str, backend: Optional[str] = None,
                 shapes: Optional[Sequence[Tuple[int, ...]]] = None) -> List[KernelConfig]:
    """The candidates of ``op`` on ``backend``; ``shapes`` (the op's key
    shapes) lists decode's heads a block, which depend on the kv heads."""
    bk = dispatch.backend() if backend is None else backend
    if bk not in dispatch.BACKENDS:
        raise ValueError(f"unknown backend {bk!r}")
    if bk == "cpu":
        return [dispatch.PLAIN]
    impl = "cuda" if bk == "cuda" else "plain"
    return [KernelConfig(impl=impl, **b) for b in _blocks(op, shapes)]


# ---------------------------------------------------------------------------
# Op runners (the ops entry points with the config forced) and plain versions
# ---------------------------------------------------------------------------
# The operands are in the kernel wrappers' flat layouts ([G,R,K] for the
# GEMMs, [N,H,T,hd] for flash, [N,T,dI] for the scan), the shapes the
# wrappers key their dispatch on.

_RUNNERS: Dict[str, Callable[..., Any]] = {
    "grouped_matmul": lambda a, c, **kw: ops.grouped_gemm(*a, config=c, **kw),
    "grouped_matmul_armt_update":
        lambda a, c, **kw: ops.grouped_gemm_armt_update(*a, config=c, **kw),
    "flash_attention": lambda a, c, **kw: ops.segment_attention(*a, config=c, **kw),
    "decode_attention": lambda a, c, **kw: ops.decode_attention(*a, config=c, **kw),
    "armt_read": lambda a, c, **kw: ops.assoc_read(*a, config=c, **kw),
    "armt_update": lambda a, c, **kw: ops.assoc_update(*a, config=c, **kw),
    "mamba_scan": lambda a, c, **kw: ops.selective_scan_fused(*a, config=c, **kw),
}

_REFS: Dict[str, Callable[..., Any]] = {
    "grouped_matmul": ref.grouped_matmul_ref,
    "grouped_matmul_armt_update": ref.grouped_matmul_armt_update_ref,
    "flash_attention": ref.flash_attention_ref,
    "decode_attention": ref.decode_attention_ref,
    "armt_read": ref.armt_read_ref,
    "armt_update": ref.armt_update_ref,
    "mamba_scan": ref.mamba_scan_ref,
}

# the operands whose shapes key an op's dispatch (what its wrapper passes)
_KEY_ARGS: Dict[str, Tuple[int, ...]] = {
    "grouped_matmul": (0, 1),
    "grouped_matmul_armt_update": (0, 1, 6),
    "flash_attention": (0, 1),
    "decode_attention": (0, 1),
    "armt_read": (0, 2),
    "armt_update": (0, 4),
    "mamba_scan": (0, 2),
}


def run_op(op: str, args: Sequence[Any], config: Optional[KernelConfig], **kw):
    """``op`` on ``args`` with ``config`` (None: the one dispatch resolves)."""
    return _RUNNERS[op](tuple(args), config, **kw)


def key_shapes(op: str, args: Sequence[Any]) -> List[Tuple[int, ...]]:
    return [tuple(args[i].shape) for i in _KEY_ARGS[op]]


def _fp32(x):
    """fp32 copies of the floating tensors of x (a tensor, tuple or dict)."""
    if isinstance(x, torch.Tensor):
        return x.float() if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: _fp32(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_fp32(v) for v in x)
    return x


def _leaves(out) -> List[torch.Tensor]:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _close(got, want, atol: float, rtol: float) -> bool:
    return all(g.shape == w.shape and torch.allclose(g.float(), w.float(), atol=atol, rtol=rtol)
               for g, w in zip(_leaves(got), _leaves(want), strict=True))


def same_bits(a, b) -> bool:
    """Outputs (tensors or tuples of them) equal to the bit."""
    return all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(
        x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8))
        for x, y in zip(_leaves(a), _leaves(b), strict=True))


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------

class Autotuner:
    """Sweeps config spaces and fills the dispatch cache.

    ``cache_path=None`` keeps the dispatch layer's current file; pass a path
    in tests. ``persist=False`` keeps winners in memory only (the dispatch
    table still serves them in this process). ``results`` holds, per cache
    key this tuner swept, the ranked candidates with their times, those
    dropped (they raised) and rejected (they failed validation), and the
    winner (None when none passed: the heuristic then stands)."""

    def __init__(self, cache_path: Optional[str] = None, *, registry=None, persist: bool = True):
        if cache_path is not None:
            dispatch.set_cache_path(cache_path)
        self.persist = persist
        if registry is None:
            from repro_torch.serve.telemetry import default_registry
            registry = default_registry()
        self.registry = registry
        self.results: Dict[str, Dict[str, Any]] = {}
        self._dropped: List[KernelConfig] = []

    @staticmethod
    def _backend(backend: Optional[str], args) -> str:
        return dispatch.backend(args[0].device) if backend is None else backend

    @staticmethod
    def _time_once(fn: Callable[[], Any], device: torch.device) -> float:
        """Seconds of one call: CUDA events on the caller's stream behind a
        spin of the card (the host's enqueue time stays out), or the host
        clock on the CPU."""
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN)
            a.record()
            fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    def sweep(self, op: str, args: Sequence[Any], *, backend: Optional[str] = None,
              repeats: int = 3, op_kwargs: Optional[Dict[str, Any]] = None
              ) -> List[Tuple[KernelConfig, float]]:
        """Times every candidate, paired: one untimed call each (a candidate
        that raises there is dropped), then ``repeats`` rounds visiting
        every candidate. -> [(config, best seconds)], fastest first."""
        kw = op_kwargs or {}
        args = tuple(args)
        dev = args[0].device
        cands: List[KernelConfig] = []
        self._dropped = []
        for cand in config_space(op, self._backend(backend, args), key_shapes(op, args)):
            try:
                run_op(op, args, cand, **kw)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            except Exception:
                self._dropped.append(cand)
                continue
            cands.append(cand)
        times: List[List[float]] = [[] for _ in cands]
        for _ in range(repeats):
            for i, cand in enumerate(cands):
                times[i].append(self._time_once(lambda c=cand: run_op(op, args, c, **kw), dev))
                self.registry.inc("autotune_sweep_total", op=op)
        return sorted(zip(cands, (min(t) for t in times)), key=lambda p: p[1])

    def validate(self, op: str, args: Sequence[Any], config: KernelConfig, *,
                 op_kwargs: Optional[Dict[str, Any]] = None, atol: float = ATOL,
                 rtol: float = RTOL, backend: Optional[str] = None, want=None,
                 base=None) -> bool:
        """Both checks of the module docstring: ``config`` on fp32 copies
        against the plain version (``want``: its output there, computed
        when None), and on ``args`` equal to the heuristic config's output
        (``base``, computed when None) to the bit. A candidate that raises
        fails."""
        kw = op_kwargs or {}
        try:
            a32, kw32 = _fp32(tuple(args)), _fp32(kw)
            if want is None:
                want = _REFS[op](*a32, **kw32)
            ok = _close(run_op(op, a32, config, **kw32), want, atol, rtol)
            if ok:
                if base is None:
                    base = run_op(op, args, dispatch.heuristic(op, self._backend(backend, args)),
                                  **kw)
                ok = same_bits(run_op(op, args, config, **kw), base)
        except Exception:
            ok = False
        self.registry.inc("autotune_validate_total", op=op, result="pass" if ok else "fail")
        return ok

    def key_for(self, op: str, args: Sequence[Any], backend: Optional[str] = None) -> str:
        return dispatch.cache_key(self._backend(backend, args), op, key_shapes(op, args),
                                  args[0].dtype)

    def get_or_tune(self, op: str, args: Sequence[Any], *, backend: Optional[str] = None,
                    repeats: int = 3, op_kwargs: Optional[Dict[str, Any]] = None
                    ) -> KernelConfig:
        """Warm: the cached entry, with no launch (refused where it does not
        fit these shapes: ``dispatch.check_fits``). Cold: sweep, validate
        fastest first (falling through to the next candidate on a
        failure), store the first that passes and return what was stored:
        the winner with each block that equals the kernel's own pick at
        these shapes set to 0 (``dispatch.rule_relative``; ``results``
        keeps the winner as swept); the heuristic when none passes
        (nothing stored)."""
        bk = self._backend(backend, args)
        key = self.key_for(op, args, bk)
        shapes = key_shapes(op, args)
        hit = dispatch.cached_config(key)
        if hit is not None:
            dispatch.check_entry(key, hit)
            dispatch.check_fits(op, shapes, hit, key)
            self.registry.inc("autotune_cache_hit_total", op=op)
            return hit
        kw = op_kwargs or {}
        ranked = self.sweep(op, args, backend=bk, repeats=repeats, op_kwargs=kw)
        record = self.results[key] = {"op": op, "ranked": ranked, "dropped": self._dropped,
                                      "rejected": [], "winner": None}
        if ranked:
            want = _REFS[op](*_fp32(tuple(args)), **_fp32(kw))
            base = run_op(op, args, dispatch.heuristic(op, bk), **kw)
            for cand, _ in ranked:
                if self.validate(op, args, cand, op_kwargs=kw, backend=bk, want=want,
                                 base=base):
                    record["winner"] = cand
                    stored = dispatch.rule_relative(cand, dispatch.rule_config(op, shapes, bk))
                    dispatch.store_config(key, stored, persist=self.persist)
                    return stored
                record["rejected"].append(cand)
        return dispatch.heuristic(op, bk)


__all__ = ["Autotuner", "config_space", "run_op", "key_shapes", "same_bits", "ATOL", "RTOL"]
