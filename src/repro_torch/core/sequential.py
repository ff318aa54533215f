"""Sequential executor: the paper's baseline schedule. Segments strictly in
order; within a segment, layers in order (paper Fig. 3a).

``run_sequential_`` updates a state in place (the port of the reference's
donated carry): each layer's new leaves are written into the stacked state
with ``copy_``, so the state keeps its buffers, and a CUDA graph captured
over it stays valid. ``run_sequential`` is the functional form: a copy of
the state, then the same in-place run."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

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
    """One layer in place: y from apply_block, and each new leaf that is
    not the state's own buffer (a cache the block updated in place) written
    into it."""
    y, new = apply_block(t, p, x, st)
    for k, v in new.items():
        if v is not st[k]:
            masked_copy_(st[k], v, row_mask)
    return y


def run_sequential_(layout, params: Dict, state: Dict, segments, apply_block: ApplyBlock,
                    *, row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """segments: [S, B, T, D] -> ys [S, B, T, D]; ``state`` is updated in
    place (with row_mask, bool [B], only its True rows).

    params/state: {'prelude': tuple of per-layer trees, 'pattern': tuple of
    trees stacked over n_super on dim 0}."""
    ys = []
    for x in segments:
        for j, t in enumerate(layout.prelude):
            x = apply_layer_(apply_block, t, params["prelude"][j], x, state["prelude"][j],
                             row_mask)
        for j in range(layout.n_super):
            for p, t in enumerate(layout.pattern):
                x = apply_layer_(apply_block, t, layer_slice(params["pattern"][p], j), x,
                                 layer_slice(state["pattern"][p], j), row_mask)
        ys.append(x)
    return torch.stack(ys)


def run_sequential(layout, params: Dict, state0: Dict, segments,
                   apply_block: ApplyBlock):
    """segments: [S, B, T, D] -> (ys [S, B, T, D], final_state); state0 is
    not modified."""
    state = clone_state({"prelude": state0["prelude"], "pattern": state0["pattern"]})
    return run_sequential_(layout, params, state, segments, apply_block), state
