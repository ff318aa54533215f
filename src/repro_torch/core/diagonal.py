"""Diagonal-batching executor (the paper's contribution, paper Alg. 1).

A slot buffer ``buf[L, B, T, D]`` holds, in slot l, the segment entering
layer l. Anti-diagonal step i (S + L - 1 of them, the Lemma 3.1 minimum)
applies one grouped cell to the valid slot band ``[max(0, i-S+1),
min(i, L-1)]`` (slot l holds segment i - l), then shifts the band's output
down one slot; the top slot's output leaves the pipeline as a finished
segment. Eager PyTorch slices the band with Python ints, so fill and drain
steps run exactly the cells that exist, with no masking: S*L cell applies,
as in the sequential schedule. The recurrence is exact: every layer's state
is updated by the same functions in the same order as the sequential
executor, only grouped across slots.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.schedule import band, n_diagonal_groups
from repro_torch.core.sequential import ApplyBlock, layer_slice, stack_layers


def _band_slice(tree, lo: int, hi: int):
    """Slots lo..hi of a stacked dict tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _band_slice(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi + 1]


def _per_slot_apply(apply_block: ApplyBlock):
    """The plain block applied slot by slot over a band: the oracle for the
    fused grouped cell (what the reference's vmap over slots computes)."""
    def grouped(t, p, x, state):
        outs = [apply_block(t, layer_slice(p, g), x[g], layer_slice(state, g))
                for g in range(x.shape[0])]
        return (torch.stack([y for y, _ in outs]),
                stack_layers([st for _, st in outs]))
    return grouped


def run_diagonal(layout, params: Dict, state0: Dict, segments: torch.Tensor,
                 apply_block: ApplyBlock, *, grouped_apply=None):
    """segments: [S, B, T, D] -> (ys [S, B, T, D], final_state); the same
    params/state structure as ``run_sequential``.

    grouped_apply: the fused grouped cell ``(btype, params [G, ...], x [G, B,
    T, D], state [G, B, ...]) -> (y, new_state)``
    (``models.grouped_blocks.make_grouped_apply``); None applies the plain
    block slot by slot (the oracle)."""
    if layout.prelude or len(layout.pattern) != 1:
        raise ValueError("the diagonal executor supports one pattern position "
                         "and no prelude")
    S = segments.shape[0]
    L = layout.n_layers
    t = layout.pattern[0]
    cell = grouped_apply if grouped_apply is not None else _per_slot_apply(apply_block)
    pattern_params = params["pattern"][0]
    # one private copy of the stacked state, updated band by band in place
    state = {k: v.clone() for k, v in state0["pattern"][0].items()}
    buf = torch.zeros((L,) + tuple(segments.shape[1:]), dtype=segments.dtype,
                      device=segments.device)
    ys = []
    for i in range(n_diagonal_groups(S, L)):
        lo, hi = band(i, S, L)
        if lo == 0:
            buf[0] = segments[i]
        y, new = cell(t, _band_slice(pattern_params, lo, hi), buf[lo:hi + 1],
                      _band_slice(state, lo, hi))
        for k, v in new.items():
            state[k][lo:hi + 1] = v
        y = y.to(buf.dtype)
        if hi == L - 1:               # segment i - (L-1) finished every layer
            # a copy: a view would keep the band's whole output alive
            # until the final stack (G times the segment, every segment)
            ys.append(y[-1].clone())
            y = y[:-1]
        buf[lo + 1:lo + 1 + y.shape[0]] = y
    final = {"prelude": state0["prelude"], "pattern": (state,)}
    return torch.stack(ys), final
