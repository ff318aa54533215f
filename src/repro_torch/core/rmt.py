"""Original RMT (Bulatov et al. 2022): the paper's Fig. 2 (left) contrast.

Memory is a sequence of token embeddings carried from the final layer's
output of segment s - 1 into the input of segment s (eq. 1):

    [_, _, M_s] = Transformer([M_{s-1}, H_s, M_{s-1}])

so cell (s, l) depends on (s - 1, L - 1): an inter-layer dependency that
makes the diagonal schedule inapplicable (the paper's Limitation 1).
``rmt_dependencies`` states it, ``diagonal_violates_rmt`` checks it
against the diagonal grouping, and ``run_rmt`` has only a sequential
executor.

Layout per segment: [read memory (M), tokens (T), write memory (M)]; the
write positions' final-layer outputs are the next segment's memory.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from repro_torch.core.schedule import StackLayout, diagonal_groups
from repro_torch.core.sequential import layer_slice, rematerialized


def rmt_dependencies(s: int, l: int, n_layers: int) -> List[Tuple[int, int]]:
    """Dependencies of cell (s, l) in the original RMT: the layer below in
    the same segment, and the last layer of the previous segment (the
    memory)."""
    deps = []
    if l > 0:
        deps.append((s, l - 1))
    if s > 0:
        deps.append((s - 1, n_layers - 1))
    return deps


def diagonal_violates_rmt(n_segments: int, n_layers: int) -> bool:
    """True iff the diagonal grouping puts a cell in a group no later than
    one of its RMT dependencies (always, for two or more layers and
    segments: (s, 0) sits in group s, (s - 1, L - 1) in group s + L - 2)."""
    level = {cell: gi for gi, g in enumerate(diagonal_groups(n_segments, n_layers))
             for cell in g}
    return any(level[dep] >= level[(s, l)]
               for s in range(n_segments) for l in range(n_layers)
               for dep in rmt_dependencies(s, l, n_layers))


def run_rmt(layout: StackLayout, params, mem0: torch.Tensor, segments: torch.Tensor,
            apply_block: Callable, *, remat: bool = False):
    """segments [S, B, T, D], mem0 [B, M, D] (the initial memory embeddings)
    -> (ys [S, B, T, D], final memory [B, M, D]), segment after segment.
    apply_block(btype, p, x, state) is the executors' block signature,
    called with an empty state (RMT's memory is global, carried here);
    remat: each layer's block under ``torch.utils.checkpoint``."""
    block = rematerialized(apply_block) if remat else apply_block
    M = mem0.shape[1]
    mem, ys = mem0, []
    for x_tokens in segments:
        x = torch.cat([mem, x_tokens, mem], dim=1)          # [B, M + T + M, D]
        for j, t in enumerate(layout.prelude):
            x, _ = block(t, params["prelude"][j], x, {})
        for j in range(layout.n_super):
            for p, t in enumerate(layout.pattern):
                x, _ = block(t, layer_slice(params["pattern"][p], j), x, {})
        mem = x[:, -M:]                                      # write positions, final layer
        ys.append(x[:, M:-M])
    return torch.stack(ys), mem
