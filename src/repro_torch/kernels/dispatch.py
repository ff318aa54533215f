"""Kernel dispatch: which implementation, and which tuning config, each
kernel wrapper call runs.

The port of the reference's dispatch layer: one resolver between every op
call and its kernel, so that the choices the kernels make per shape (the
GEMM's column tile, the scan's channels a block, decode's q heads a block)
are made in one place, where they can be overridden, cached and counted.
The seven wrappers (``grouped_matmul``, ``grouped_matmul_armt_update``,
``flash_attention``, ``decode_attention``, ``armt_read``, ``armt_update``,
``mamba_scan``) each ask ``config_for`` once per call.

Resolution order (``resolve``):

1. the per-call override ``use_kernel``: ``False`` the plain PyTorch
   version, ``True`` the CUDA kernel with the heuristic's config;
2. the autotune cache: winners that ``kernels/autotune.py`` measured and
   validated on the card, keyed ``backend/op/shape bucket/dtype`` and kept
   on disk (``set_cache_path``; ``REPRO_TORCH_KERNEL_CACHE``; by default
   ``~/.cache/repro_torch/kernel_cache.json``, a file of the port's own:
   no key or file is shared with the JAX package's cache);
3. the heuristic table ``HEURISTICS``: on the card every op runs its CUDA
   kernel with every block field 0, which each kernel reads as its own
   rule at the call's exact shape (``choose_bn`` in
   ``csrc/grouped_matmul.cu``, ``choose_block`` in ``csrc/mamba_scan.cu``,
   ``decode_attention.head_groups``), so an empty cache runs what the
   kernels ran before this layer existed; on the CPU every op runs its
   plain version. ``rule_config`` asks the kernels what those rules pick.

No fallback: on a CUDA tensor only ``use_kernel=False`` reaches the plain
version (the oracle of the tests and the card checks; nothing on the main
path passes it). A cached entry that asks the ``cuda`` backend for
``"plain"``, or the CPU for ``"cuda"``, raises; it is never obeyed.

Each resolution is counted in ``kernel_dispatch_total{op,impl,backend,
source}`` of the serve stack's default registry. The reference resolves at
trace time, once per compiled specialization; the port's eager band steps
call every wrapper thousands of times, so ``resolve`` memoises its answer
per (op, backend, shape bucket, dtype, override): the counter moves once
per new key, and a later call costs one dict lookup of its exact shapes.
``set_cache_path``, ``store_config`` and a reset of the default registry
drop the memo. A captured program (``core/capture.py``) keeps the configs
it was captured with: its replays launch what its capture launched,
whatever the cache says later.

Shape bucketing, as the reference's: every dim is rounded up to a power of
two, so one tuned config serves every shape of its bucket. The autotuner
stores a winner relative to the kernel's rule (``rule_relative``: a block
equal to the rule's pick is stored as 0), and ``resolve`` refuses a cached
block that the call's exact shape cannot run (``check_fits``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

OPS = (
    "grouped_matmul",
    "grouped_matmul_armt_update",
    "flash_attention",
    "decode_attention",
    "armt_read",
    "armt_update",
    "mamba_scan",
)

# "test": the autotuner's pseudo-backend for the CPU, whose candidates run
# the plain versions under distinct configs (the reference's "interpret")
BACKENDS = ("cpu", "cuda", "test")
IMPLS = ("cuda", "plain")
BLOCK_FIELDS = ("block_n", "block_i", "block_h")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One dispatch decision: the implementation and its tuning knobs.

    ``impl``: ``"cuda"`` the hand-written kernel, ``"plain"`` its plain
    PyTorch version (``kernels/ref.py``). A block field of 0 means the
    kernel's own rule at the call's shape; each wrapper reads only the
    fields its kernel takes (``blocks()``):

    * ``block_n``: the TMA + wgmma GEMM's column tile, 128 or 256
      (``grouped_matmul``, the fused update's GEMM, ``armt_read``'s bf16
      product); the fp32 SIMT route has none;
    * ``block_i``: ``mamba_scan``'s channels a block, 64 or 256;
    * ``block_h``: ``decode_attention``'s q heads a block, at most the q
      heads of a kv head, times the head dim at most 1,024.
    """
    impl: str = "plain"
    block_n: int = 0
    block_i: int = 0
    block_h: int = 0

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"KernelConfig: impl {self.impl!r} not in {IMPLS}")
        for f in BLOCK_FIELDS:
            v = getattr(self, f)
            if not isinstance(v, int) or v < 0:
                raise ValueError(f"KernelConfig: {f} {v!r} must be an int >= 0")

    def blocks(self, *names: str) -> Dict[str, int]:
        """The requested block fields that are set (nonzero)."""
        return {n: getattr(self, n) for n in names if getattr(self, n)}

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "KernelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


PLAIN = KernelConfig(impl="plain")
CUDA = KernelConfig(impl="cuda")


def backend(device=None) -> str:
    """``"cuda"`` or ``"cpu"``: of ``device`` (a tensor's), or without one
    of this process (``"cuda"`` where a card is visible)."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    kind = device.type if isinstance(device, torch.device) else torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"kernel dispatch: unsupported device {device}")
    return kind


# ---------------------------------------------------------------------------
# The heuristic table
# ---------------------------------------------------------------------------
# (backend, op) -> KernelConfig. On the card, every block 0: each kernel's
# own rule, the choice the port made before the dispatch layer. The
# reference's TPU and GPU rows tune Pallas knobs the port has no use for.

def _want_impl(bk: str) -> str:
    return "cuda" if bk == "cuda" else "plain"


HEURISTICS: Dict[Tuple[str, str], KernelConfig] = {
    (bk, op): KernelConfig(impl=_want_impl(bk)) for bk in BACKENDS for op in OPS}


def heuristic(op: str, bk: Optional[str] = None) -> KernelConfig:
    return HEURISTICS[(backend() if bk is None else bk, op)]


# ---------------------------------------------------------------------------
# The autotune cache (disk-backed, loaded at first use, written by autotune.py)
# ---------------------------------------------------------------------------

_cache: Optional[Dict[str, KernelConfig]] = None
_cache_path: Optional[str] = None


def default_cache_path() -> str:
    return os.environ.get(
        "REPRO_TORCH_KERNEL_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "kernel_cache.json"))


def cache_path() -> str:
    """The cache file this process reads and writes."""
    return _cache_path or default_cache_path()


def set_cache_path(path: Optional[str]) -> None:
    """Points the dispatch layer at a cache file (None: the default path).
    Drops the in-memory table and the memo, so the next resolve reloads."""
    global _cache_path, _cache
    _cache_path = path
    _cache = None
    _drop_memo()


def _load_cache() -> Dict[str, KernelConfig]:
    global _cache
    if _cache is None:
        _cache = {}
        path = cache_path()
        if os.path.exists(path):
            try:
                with open(path) as f:
                    raw = json.load(f)
                _cache = {k: KernelConfig.from_json(v)
                          for k, v in raw.get("configs", {}).items()}
            except (OSError, ValueError, TypeError, AttributeError):
                _cache = {}
    return _cache


def check_entry(key: str, cfg: KernelConfig) -> None:
    bk = key.split("/", 1)[0]
    if cfg.impl != _want_impl(bk):
        raise ValueError(f"kernel cache {cache_path()}: {key} asks for {cfg.impl!r}; the {bk} "
                         f"backend runs only {_want_impl(bk)!r} (use_kernel=False is the one "
                         "way to a plain version on the card)")


def check_fits(op: str, shapes, cfg: KernelConfig, key: Optional[str] = None) -> None:
    """Refuses a config whose blocks the kernel cannot run at these exact
    shapes. A cached entry serves its whole shape bucket, and the GEMM's
    and the scan's blocks run at any shape, but decode's ``block_h`` runs
    only where it is at most the call's q heads a kv head and, times the
    head dim, at most 1,024 outputs: a winner tuned at 4 heads a kv head
    must not reach a call with 3 in the same bucket. Raises ValueError."""
    if op != "decode_attention" or not cfg.block_h:
        return
    from repro_torch.kernels.decode_attention import MAX_GROUP_WIDTH
    (_, Hq, hd), Hkv = tuple(shapes[0]), tuple(shapes[1])[2]
    rep = Hq // Hkv
    if cfg.block_h > rep or cfg.block_h * hd > MAX_GROUP_WIDTH:
        where = f"kernel cache {cache_path()}: {key}" if key else op
        raise ValueError(f"{where}: block_h {cfg.block_h} does not fit decode_attention at "
                         f"{[tuple(s) for s in shapes]} ({rep} q heads a kv head, head dim "
                         f"{hd}: 1 <= block_h <= {min(rep, MAX_GROUP_WIDTH // hd)})")


def rule_relative(cfg: KernelConfig, rule: KernelConfig) -> KernelConfig:
    """``cfg`` with each block field that equals ``rule``'s set to 0, the
    form the autotuner stores: a winner that is the kernel's own pick at
    the shape it was tuned at serves the other shapes of its bucket as
    their own rule's pick, which may differ, and only a field that beat the
    rule carries its value over."""
    return dataclasses.replace(cfg, **{f: 0 for f in BLOCK_FIELDS
                                       if getattr(cfg, f) == getattr(rule, f)})


def store_config(key: str, cfg: KernelConfig, persist: bool = True) -> None:
    """Installs an autotuned winner (autotune.py's write path); drops the
    memo, so the next resolve of its bucket reads it."""
    check_entry(key, cfg)
    cache = _load_cache()
    cache[key] = cfg
    if persist:
        path = cache_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"configs": {k: v.to_json() for k, v in cache.items()}}, f, indent=1)
    _drop_memo()


def cached_config(key: str) -> Optional[KernelConfig]:
    return _load_cache().get(key)


# ---------------------------------------------------------------------------
# Shape bucketing and cache keys
# ---------------------------------------------------------------------------

def _pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length() if n > 1 else 1


def shape_bucket(shapes: Iterable[Tuple[int, ...]]) -> Tuple[Tuple[int, ...], ...]:
    """Every dim of every operand shape rounded up to a power of two."""
    return tuple(tuple(_pow2(d) for d in s) for s in shapes)


def dtype_name(dtype) -> str:
    """The numpy name of a torch or numpy dtype (``bfloat16``, ``float32``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


def cache_key(bk: str, op: str, shapes: Iterable[Tuple[int, ...]], dtype) -> str:
    bs = "x".join("_".join(map(str, s)) for s in shape_bucket(shapes))
    return f"{bk}/{op}/{bs}/{dtype_name(dtype)}"


# ---------------------------------------------------------------------------
# The resolver
# ---------------------------------------------------------------------------

_memo: Dict[tuple, KernelConfig] = {}     # exact call key -> config
_seen: Dict[tuple, KernelConfig] = {}     # bucket key -> config (counted once each)
MEMO_MAX = 4096                           # exact keys kept before the memo starts over
_hooked = False


def _drop_memo() -> None:
    _memo.clear()
    _seen.clear()


def _registry():
    # lazy: the kernels must not import the serve stack when they load
    global _hooked
    from repro_torch.serve.telemetry import default_registry
    reg = default_registry()
    if not _hooked:
        reg.register_reset_hook(_drop_memo)   # a reset counter is counted again
        _hooked = True
    return reg


def _resolve(op: str, shapes, dtype, use_kernel: Optional[bool], bk: str) -> KernelConfig:
    if op not in OPS:
        raise ValueError(f"kernel dispatch: unknown op {op!r}")
    name = dtype_name(dtype)
    skey = (op, bk, shape_bucket(shapes), name, use_kernel)
    cfg = _seen.get(skey)
    if cfg is not None:
        return cfg
    if use_kernel is not None:
        cfg, source = (CUDA if use_kernel else PLAIN), "override"
    else:
        key = cache_key(bk, op, shapes, name)
        hit = cached_config(key)
        if hit is not None:
            check_entry(key, hit)
            cfg, source = hit, "cache"
        else:
            cfg, source = heuristic(op, bk), "heuristic"
    _registry().inc("kernel_dispatch_total", op=op, impl=cfg.impl, backend=bk, source=source)
    _seen[skey] = cfg
    return cfg


def resolve(op: str, shapes: Iterable[Tuple[int, ...]], dtype, *,
            use_kernel: Optional[bool] = None, device=None) -> KernelConfig:
    """The KernelConfig of one op call on ``device`` (None: this process's
    backend): the override, else the cache, else the heuristic. Host-only
    (no device work), and after a key's first call one dict lookup."""
    shapes = tuple(tuple(s) for s in shapes)
    bk = backend(device)
    key = (op, bk, dtype, use_kernel) + shapes
    cfg = _memo.get(key)
    if cfg is None:
        cfg = _resolve(op, shapes, dtype, use_kernel, bk)
        check_fits(op, shapes, cfg, cache_key(bk, op, shapes, dtype))
        if len(_memo) >= MEMO_MAX:
            _memo.clear()
        _memo[key] = cfg
    return cfg


def config_for(op: str, shapes, t: torch.Tensor, config: Optional[KernelConfig] = None,
               use_kernel: Optional[bool] = None) -> KernelConfig:
    """The config a wrapper call on tensor ``t`` runs: ``config`` where the
    caller passed one (the autotuner's candidates), else ``resolve``'s for
    t's device. A ``"plain"`` config on a CUDA tensor is refused: there
    ``use_kernel=False`` is the one way to the plain version."""
    if config is None:
        return resolve(op, shapes, t.dtype, use_kernel=use_kernel, device=t.device)
    if config.impl == "plain" and t.device.type == "cuda":
        raise ValueError(f"{op}: a 'plain' config on a CUDA tensor; the card runs its kernel "
                         "(use_kernel=False is the one way to the plain version)")
    check_fits(op, shapes, config)
    return config


def rule_config(op: str, shapes: Iterable[Tuple[int, ...]], bk: str = "cuda") -> KernelConfig:
    """``CUDA`` with each block made concrete: what the kernel's own rule
    picks at these exact shapes on this card (the kernel library asked; the
    GEMMs' column tile for a bf16 output). Needs the card. Another backend
    has no rule: its heuristic."""
    if bk != "cuda":
        return heuristic(op, bk)
    from repro_torch.kernels import build
    s = [tuple(x) for x in shapes]
    if op in ("grouped_matmul", "grouped_matmul_armt_update"):
        (G, R, _), N = s[0], s[1][-1]
        return dataclasses.replace(CUDA, block_n=build.lib().gmm_choose_bn(G, R, N, 0, 0))
    if op == "armt_read":
        (N, T, _), Dv = s[0], s[1][-1]
        return dataclasses.replace(CUDA, block_n=build.lib().gmm_choose_bn(N, T, Dv, 0, 1))
    if op == "mamba_scan":
        N, _, dI = s[0]
        return dataclasses.replace(CUDA, block_i=build.lib().mamba_scan_choose_block(N, dI))
    if op == "decode_attention":
        from repro_torch.kernels.decode_attention import head_groups
        (_, Hq, hd), Hkv = s[0], s[1][2]
        return dataclasses.replace(CUDA, block_h=head_groups(Hq // Hkv, hd)[0])
    return CUDA
