"""Sequential executor: the paper's baseline schedule. Segments strictly in
order; within a segment, layers in order (paper Fig. 3a).

``run_sequential_`` updates a state in place (the port of the reference's
donated carry): each layer's new leaves are written into the stacked state
with ``copy_``, so the state keeps its buffers, and a CUDA graph captured
over it stays valid. ``run_sequential`` is the functional form: a copy of
the state, then the same in-place run.

With a capture (``capture_init``), the recurrent state after every segment
is copied out into buffers with a leading [S] axis: in this schedule each
segment's end is a segment boundary, so no reindexing is needed (the
diagonal executor's capture is per step, ``core/diagonal.py``).

Only the recurrent leaves (``RECURRENT_KEYS``) change: a whisper ``dec``
layer's cross K/V (``ck``/``cv``) is read, never written back, copied or
captured.

Under gradients (``training(params, segments)``: grad mode on and a
parameter or the input that requires one) ``run_sequential`` takes an
out-of-place form: each layer's state is carried as the new tensors its
block returns, never written into a buffer a block has read, and stacked
into the usual tree at the end. It gives the same bits as the in-place
form. With ``remat`` each layer's block runs under
``torch.utils.checkpoint`` (recomputed in the backward from its inputs;
the reference's ``jax.checkpoint``). A capture is forward-only.

On a mesh's 'stage' axis (the ``comm.StageParallel`` context) a rank runs
its block [a, b) of the layers: per segment, the first stage takes the
segment, every other the block output the stage before handed on
(``comm.stage_shift``), and every stage but the last hands its own on. The
stages run as a pipeline over the segments (stage r at segment s in step
s + r), and each layer still sees its segments in order, so the bits are
the one-device run's. ``run_sequential_`` returns the block's outputs
(the decode step and the flush take what they need of the last stage's);
``run_sequential`` returns the last stage's on every rank
(``comm.stage_last``). The capture and the state are the block's; the
recorded cells are the global (segment, layer) ones."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.memory import RECURRENT_KEYS
from repro_torch.core.schedule import record_step
from repro_torch.parallel import comm

# apply_block(btype, layer_params, x, layer_state) -> (y, new_layer_state)
ApplyBlock = Callable[[str, Any, torch.Tensor, Any], tuple]


def layer_slice(tree, i: int):
    """Layer i of a stacked ``[n_super, ...]`` dict tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def stack_layers(trees):
    """Inverse of ``layer_slice`` over all layers: list of trees -> stacked."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_layers([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def one_layer_cell(cell):
    """A grouped cell applied to one layer: the executors' block signature
    on a band of G = 1 (param and state leaves gain a leading dim of 1, x
    [B, T, D] becomes [1, B, T, D]; views, no copies)."""
    def lift(tree):
        if isinstance(tree, dict):
            return {k: lift(v) for k, v in tree.items()}
        return tree[None]

    def apply(t, p, x, state):
        y, new = cell(t, lift(p), x[None], lift(state))
        return y[0], {k: v[0] for k, v in new.items()}
    return apply


def exec_state_copy(state: Dict) -> Dict:
    """An executor state ({'prelude', 'pattern'}) for a run to update in
    place: its recurrent leaves copied, the constant ones (``ck``/``cv``)
    the same tensors."""
    return {part: tuple({k: v.clone() if k in RECURRENT_KEYS else v for k, v in tree.items()}
                        for tree in state[part]) for part in ("prelude", "pattern")}


def clone_state(tree):
    """A copy of a state tree (dicts and tuples of tensors; other leaves,
    such as a Python int position, as they are)."""
    if isinstance(tree, dict):
        return {k: clone_state(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(clone_state(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def masked_copy_(dst: torch.Tensor, new: torch.Tensor, row_mask: Optional[torch.Tensor]):
    """dst <- new in place; with row_mask (bool [B], batch on dst's dim 0)
    only the rows where it is True, the others kept bit for bit."""
    if row_mask is not None:
        new = torch.where(row_mask.reshape((-1,) + (1,) * (dst.dim() - 1)), new, dst)
    dst.copy_(new)


def apply_layer_(apply_block: ApplyBlock, t: str, p, x, st: Dict,
                 row_mask: Optional[torch.Tensor] = None):
    """One layer in place: y from apply_block, and each new recurrent leaf
    that is not the state's own buffer written into it (a cache the block
    updated in place, or a constant cross K/V, is left as it is)."""
    y, new = apply_block(t, p, x, st)
    for k, v in new.items():
        if k in RECURRENT_KEYS and v is not st[k]:
            masked_copy_(st[k], v, row_mask)
    return y


def capture_init(state: Dict, n_segments: int) -> Dict:
    """Buffers for the recurrent leaves (A, z; h, conv) of a state tree,
    each with a leading [n_segments] axis."""
    def one(tree):
        return {k: torch.empty((n_segments,) + tuple(v.shape), dtype=v.dtype, device=v.device)
                for k, v in tree.items() if k in RECURRENT_KEYS}
    return {part: tuple(one(t) for t in state[part]) for part in ("prelude", "pattern")}


def capture_write_(capture: Dict, state: Dict, s: int) -> None:
    """Copies the recurrent leaves of ``state`` into entry s of a capture."""
    for part in ("prelude", "pattern"):
        for cap, st in zip(capture[part], state[part]):
            for k, buf in cap.items():
                buf[s].copy_(st[k])


def run_sequential_(layout, params: Dict, state: Dict, segments, apply_block: ApplyBlock,
                    *, row_mask: Optional[torch.Tensor] = None,
                    capture: Optional[Dict] = None) -> torch.Tensor:
    """segments: [S, B, T, D] -> ys [S, B, T, D]; ``state`` is updated in
    place (with row_mask, bool [B], only its True rows). capture: buffers
    from ``capture_init``, into which the recurrent state after segment s
    is copied as entry s.

    params/state: {'prelude': tuple of per-layer trees, 'pattern': tuple of
    trees stacked over n_super on dim 0}.

    In a stage context: the layout, params and state are the stage's
    block, segments are read on the first stage only (the others may pass
    a placeholder of their shape), and ys are the block's outputs."""
    sp = comm.current_stage()
    L, a, r, n = ((layout.n_layers, 0, 0, 1) if sp is None
                  else (sp.n_layers, sp.lo, sp.index, sp.size))
    S, n_pre, P = segments.shape[0], len(layout.prelude), len(layout.pattern)
    ys, got = [], None
    for i in range(S + n - 1):
        s = i - r                       # the segment this stage runs at step i
        x = None
        if 0 <= s < S:
            x = segments[s] if r == 0 else got
            for j, t in enumerate(layout.prelude):
                x = apply_layer_(apply_block, t, params["prelude"][j], x,
                                 state["prelude"][j], row_mask)
                record_step(state, s * L + a + j, ((s, a + j),))
            for j in range(layout.n_super):
                for p, t in enumerate(layout.pattern):
                    x = apply_layer_(apply_block, t, layer_slice(params["pattern"][p], j), x,
                                     layer_slice(state["pattern"][p], j), row_mask)
                    l = a + n_pre + j * P + p
                    record_step(state, s * L + l, ((s, l),))
            ys.append(x)
            if capture is not None:
                capture_write_(capture, state, s)
        if sp is not None:
            # this block's output to the next stage; the stage before's
            # output of the segment this stage runs next
            got = comm.stage_shift(segments[0] if x is None else x, sp.mesh,
                                   send=x is not None, recv=0 <= s + 1 < S)
    return torch.stack(ys)


def training(*trees) -> bool:
    """Gradients on and a tensor leaf of the trees (dicts, tuples, tensors)
    that requires one: the executors then take their out-of-place forms
    (they ask about their params and their input segments)."""
    def any_requires(tree):
        if isinstance(tree, dict):
            return any(any_requires(v) for v in tree.values())
        if isinstance(tree, (tuple, list)):
            return any(any_requires(v) for v in tree)
        return isinstance(tree, torch.Tensor) and tree.requires_grad
    return torch.is_grad_enabled() and any(any_requires(t) for t in trees)


def rematerialized(block: ApplyBlock) -> ApplyBlock:
    """``block`` under ``torch.utils.checkpoint`` (non-reentrant): only its
    inputs are kept for the backward, which runs it again. The same
    values: the kernels are deterministic and draw no random numbers."""
    def apply(t, p, x, state, **kw):
        return checkpoint(block, t, p, x, state, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return apply


def with_new_state(state: Dict, new: Dict) -> Dict:
    """A layer's state after its block: the new recurrent leaves, the
    others (a dec layer's ck/cv) as they were."""
    return {k: new[k] if k in RECURRENT_KEYS and k in new else v for k, v in state.items()}


def stacked_state(state0: Dict, prelude, pattern) -> Dict:
    """The executor state tree from per-layer states (``prelude``: one dict
    per prelude layer; ``pattern``: per position, a list of one dict per
    layer): the recurrent leaves stacked over the layers, the constant ones
    state0's tensors."""
    return {"prelude": tuple(prelude),
            "pattern": tuple({k: torch.stack([st[k] for st in layers]) if k in RECURRENT_KEYS
                              else v for k, v in tree.items()}
                             for tree, layers in zip(state0["pattern"], pattern))}


def run_sequential_grad(layout, params: Dict, state0: Dict, segments,
                        apply_block: ApplyBlock, *, remat: bool = False):
    """The out-of-place form of ``run_sequential`` (for gradients):
    segments [S, B, T, D] -> (ys, final_state), each layer's state carried
    as its block's new tensors; remat: each block call under
    ``rematerialized``."""
    block = rematerialized(apply_block) if remat else apply_block
    prelude = list(state0["prelude"])
    pattern = [[layer_slice(tree, j) for j in range(layout.n_super)]
               for tree in state0["pattern"]]
    ys = []
    for x in segments:
        for j, t in enumerate(layout.prelude):
            x, new = block(t, params["prelude"][j], x, prelude[j])
            prelude[j] = with_new_state(prelude[j], new)
        for j in range(layout.n_super):
            for p, t in enumerate(layout.pattern):
                x, new = block(t, layer_slice(params["pattern"][p], j), x, pattern[p][j])
                pattern[p][j] = with_new_state(pattern[p][j], new)
        ys.append(x)
    return torch.stack(ys), stacked_state(state0, prelude, pattern)


def run_sequential(layout, params: Dict, state0: Dict, segments,
                   apply_block: ApplyBlock, *, capture_states: bool = False,
                   remat: bool = False):
    """segments: [S, B, T, D] -> (ys [S, B, T, D], final_state); state0 is
    not modified. capture_states: also return, third, the recurrent state
    after every segment, leaves with a leading [S] axis (forward-only).
    Under gradients (``training(params, segments)``) the out-of-place form
    runs, ``run_sequential_grad`` (remat: each block rematerialized). In a
    stage context ys are the last stage's on every rank; training there is
    refused."""
    if training(params, segments):
        if comm.current_stage() is not None:
            raise ValueError("run_sequential under gradients on a 'stage' mesh: the "
                             "reference trains on no stage axis, and neither does the port")
        if capture_states:
            raise ValueError("run_sequential: capture_states is forward-only")
        return run_sequential_grad(layout, params, state0, segments, apply_block,
                                   remat=remat)
    state = exec_state_copy(state0)
    cap = capture_init(state, segments.shape[0]) if capture_states else None
    ys = comm.stage_last(run_sequential_(layout, params, state, segments, apply_block,
                                         capture=cap))
    return (ys, state, cap) if capture_states else (ys, state)
