"""Sequential executor: the paper's baseline schedule. Segments strictly in
order; within a segment, layers in order (paper Fig. 3a)."""
from __future__ import annotations

from typing import Any, Callable, Dict

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


def run_sequential(layout, params: Dict, state0: Dict, segments,
                   apply_block: ApplyBlock):
    """segments: [S, B, T, D] -> (ys [S, B, T, D], final_state).

    params/state: {'prelude': tuple of per-layer trees, 'pattern': tuple of
    trees stacked over n_super on dim 0}."""
    P = len(layout.pattern)
    prelude = list(state0["prelude"])
    pattern = [[layer_slice(st, j) for j in range(layout.n_super)]
               for st in state0["pattern"]]
    ys = []
    for x in segments:
        for j, t in enumerate(layout.prelude):
            x, prelude[j] = apply_block(t, params["prelude"][j], x, prelude[j])
        for j in range(layout.n_super):
            for p, t in enumerate(layout.pattern):
                x, pattern[p][j] = apply_block(
                    t, layer_slice(params["pattern"][p], j), x, pattern[p][j])
        ys.append(x)
    final = {"prelude": tuple(prelude),
             "pattern": tuple(stack_layers(pattern[p]) for p in range(P))}
    return torch.stack(ys), final
