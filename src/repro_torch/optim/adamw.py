"""AdamW, the learning-rate schedule and global-norm clipping, over the
port's parameter trees (dicts and tuples of tensors).

Mixed precision as in the reference: params may be bf16, the moments are
kept in ``moment_dtype`` (fp32 by default), and the update math runs in
fp32 with one cast back to the param dtype. ``factored_v`` keeps an
Adafactor-style factored second moment (row and column means) for every
leaf of two or more dims. The step counter, the learning rate and the
norms are 0-d tensors on the params' device: nothing is read back to the
host, so a train step can skip a non-finite update on the device.

On a mesh (``mesh=`` and ``specs=``, the ``Sharding`` trees of a rank's
local view of the params and the optimizer state, ``train/state.py``
``train_specs``) the update runs on the rank's local view: the global norm
counts each element once (a leaf cut over 'model' sums its squares over
the axis, a replicated one counts once), and where ZeRO-1 cuts a leaf's
moments over the DP axes (``parallel/sharding.py`` ``opt_state_specs``) the
rank updates only its block of the param from the all-reduced gradient,
then all-gathers the param over those axes. The update is elementwise, so
a block gives the bits the whole leaf's update gives there. A factored
second moment (vr, vc) stays replicated, computed from the whole
gradient, as the reference keeps it; it is not ported for a leaf cut over
'model'.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.parallel import comm
from repro_torch.parallel.sharding import spec_of
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"
    # factored second moment for leaves of >= 2 dims: v kept as row and
    # column means, O(n + m) instead of O(n m)
    factored_v: bool = False


def lr_schedule(ocfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr``; step a
    0-d tensor -> a 0-d fp32 tensor on its device."""
    step = step.float()
    warm = torch.clamp(step / max(ocfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - ocfg.warmup_steps)
                       / max(ocfg.total_steps - ocfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(torch.pi * prog))
    return ocfg.lr * warm * (ocfg.min_lr_ratio + (1 - ocfg.min_lr_ratio) * cos)


def _sq(leaves) -> torch.Tensor:
    return sum(l.float().square().sum() for l in leaves)


def global_norm(tree: Any, *, mesh=None, split=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (0-d). On a mesh,
    ``split`` flags the leaves (in order) that are this rank's block of a
    leaf cut over 'model': their squares are summed over the axis, the
    replicated leaves' counted once."""
    leaves = tree_leaves(tree)
    if mesh is None or not any(split):
        return torch.sqrt(_sq(leaves))
    parts = comm.all_reduce(_sq([l for l, c in zip(leaves, split) if c]), mesh, "model")
    return torch.sqrt(parts + _sq([l for l, c in zip(leaves, split) if not c]))


def clip_by_global_norm(grads: Any, max_norm: float, **mesh) -> Tuple[Any, torch.Tensor]:
    """(grads scaled by min(1, max_norm / (norm + 1e-9)), each in its own
    dtype; the norm before scaling). mesh: ``global_norm``'s."""
    gnorm = global_norm(grads, **mesh)
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


def _is_factored(p: torch.Tensor, ocfg: OptimConfig) -> bool:
    return ocfg.factored_v and p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def _is_v_leaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {"vr", "vc"}


def adamw_init(params: Any, ocfg: OptimConfig) -> Dict:
    """{"m": zeros like params, "v": zeros (a factored leaf {"vr", "vc"} in
    fp32), "step": int32 0} in ``moment_dtype`` on the params' device."""
    mdt = _DTYPES[ocfg.moment_dtype]

    def v_init(p):
        if _is_factored(p, ocfg):
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                      device=p.device)}
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params),
            "v": tree_map(v_init, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _mesh_plan(specs: Dict) -> Tuple[list, list]:
    """From the ``Sharding`` trees {"params", "opt"} of a rank's local view:
    for every param leaf, in order, whether it is cut over 'model', and
    its ZeRO-1 cut (dim, DP axes) where its moments are cut over axes its
    param is not (None where the moments follow the param)."""
    split, zero = [], []
    for ps, ms in zip(tree_leaves(specs["params"]), tree_leaves(specs["opt"]["m"])):
        ps, ms = spec_of(ps), spec_of(ms)
        split.append(any("model" in _axes(e) for e in ps))
        cut = [(d, m) for d, (p, m) in enumerate(zip(ps, ms)) if _axes(p) != _axes(m)]
        zero.append(cut[0] if cut else None)
    return split, zero


def adamw_update(params: Any, grads: Any, opt: Dict, ocfg: OptimConfig, *,
                 mesh=None, specs: Dict = None) -> Tuple[Any, Dict, Dict]:
    """-> (new params, new opt state, {"lr", "grad_norm"}), all new
    tensors (the inputs are not modified); grads clipped to
    ``clip_norm`` first when it is > 0, grad_norm the norm before.
    mesh, specs: a rank's local view (the module's docstring); the grads
    are the whole gradient of the rank's params (all-reduced over the DP
    axes)."""
    split, zero = _mesh_plan(specs) if mesh is not None else (None, None)
    norm_kw = {"mesh": mesh, "split": split}
    if ocfg.clip_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, ocfg.clip_norm, **norm_kw)
    else:
        gnorm = global_norm(grads, **norm_kw)
    step = opt["step"] + 1
    lr = lr_schedule(ocfg, step)
    b1, b2 = ocfg.b1, ocfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    mdt = _DTYPES[ocfg.moment_dtype]

    def new_v(g32, v):
        if isinstance(v, dict):   # factored
            g2 = g32 * g32 + 1e-30
            return {"vr": b2 * v["vr"] + (1 - b2) * g2.mean(-1),
                    "vc": b2 * v["vc"] + (1 - b2) * g2.mean(-2)}
        return (b2 * v.float() + (1 - b2) * g32 * g32).to(mdt)

    def vhat(v):
        if isinstance(v, dict):
            vr, vc = v["vr"], v["vc"]
            return (vr[..., None] * vc[..., None, :]
                    / (vr.mean(-1)[..., None, None] + 1e-30)) / bc2
        return v.float() / bc2

    new_p, new_m, new_vs = [], [], []
    for i, (p, g, m, v) in enumerate(zip(tree_leaves(params), tree_leaves(grads),
                                         tree_leaves(opt["m"]),
                                         tree_leaves(opt["v"], is_leaf=_is_v_leaf))):
        cut = None if zero is None else zero[i]

        def block(t):
            # this rank's ZeRO-1 block of a leaf of the param's shape
            if cut is None:
                return t
            lo, hi = comm.block_range(t.shape[cut[0]], mesh, cut[1])
            return t.narrow(cut[0], lo, hi - lo)
        g32 = block(g).float()
        m2 = (b1 * m.float() + (1 - b1) * g32).to(mdt)
        if isinstance(v, dict):   # replicated: the whole leaf's statistics, then the block
            v2 = new_v(g.float(), v)
            vh = block(vhat(v2))
        else:
            v2 = new_v(g32, v)
            vh = vhat(v2)
        delta = (m2.float() / bc1) / (torch.sqrt(vh) + ocfg.eps)
        p32 = block(p).float()
        p2 = (p32 - lr * (delta + ocfg.weight_decay * p32)).to(p.dtype)
        new_p.append(p2 if cut is None else comm.all_gather(p2, mesh, cut[1], cut[0]))
        new_m.append(m2)
        new_vs.append(v2)
    new_opt = {"m": tree_unflatten(opt["m"], new_m),
               "v": tree_unflatten(opt["v"], new_vs, is_leaf=_is_v_leaf), "step": step}
    return tree_unflatten(params, new_p), new_opt, {"lr": lr, "grad_norm": gnorm}
