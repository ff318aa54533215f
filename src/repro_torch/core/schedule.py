"""Diagonal-batching schedule as data + the layer-stack layout.

The (segment s, layer l) grid has edges (s,l-1)->(s,l) and (s-1,l)->(s,l).
Diagonal batching executes group i = {(s,l) : s+l = i}, i = 0..S+L-2, which
is minimal (paper Lemma 3.1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


def diagonal_groups(n_segments: int, n_layers: int) -> List[List[Tuple[int, int]]]:
    """Groups of (segment, layer) cells; group i holds cells with s+l == i."""
    groups: List[List[Tuple[int, int]]] = [[] for _ in range(n_segments + n_layers - 1)]
    for s in range(n_segments):
        for l in range(n_layers):
            groups[s + l].append((s, l))
    return groups


def n_diagonal_groups(n_segments: int, n_layers: int) -> int:
    """Anti-diagonal groups of the (S, L) grid: the Lemma 3.1 minimum."""
    return n_segments + n_layers - 1


def band(i: int, n_segments: int, n_layers: int) -> Tuple[int, int]:
    """Valid slot band [lo, hi] of anti-diagonal step i: slot l holds
    segment i - l, which exists iff 0 <= i - l < S."""
    return max(0, i - n_segments + 1), min(i, n_layers - 1)


# ---------------------------------------------------------------------------
# Cursors of a suspended pipeline (core/diagonal.py ``pipeline_step``) and of
# a pool of them (``pipeline_step_pool``): host arithmetic on the group
# cursor, never a device read
# ---------------------------------------------------------------------------

def segments_completed(step: int, n_segments: int, n_layers: int) -> int:
    """Segments that have passed every layer after ``step`` groups (segment
    s finishes at group s + L - 1), clipped to [0, S]: an overshot cursor
    reads as all done."""
    return max(0, min(step - (n_layers - 1), n_segments))


def segments_entered(step: int, n_segments: int, n_layers: int) -> int:
    """Segments inserted into slot 0 after ``step`` groups (segment s
    enters at group s), clipped to the grid."""
    del n_layers
    return max(0, min(step, n_segments))


def group_size(i: int, n_segments: int, n_layers: int) -> int:
    """Cells in anti-diagonal group i: the width of its band."""
    lo = max(0, i - (n_layers - 1))
    hi = min(n_segments - 1, i)
    return max(0, hi - lo + 1)


def cells_completed(step: int, n_segments: int, n_layers: int) -> int:
    """(segment, layer) cells run after ``step`` groups; S*L once the grid
    is done (overshoot groups run nothing)."""
    n = max(0, min(step, n_diagonal_groups(n_segments, n_layers)))
    return sum(group_size(i, n_segments, n_layers) for i in range(n))


def pool_cells_remaining(steps, segment_counts, n_layers: int) -> int:
    """Cells not yet run across a pool of suspended pipelines; ``steps`` and
    ``segment_counts`` are parallel per-member lists."""
    if len(steps) != len(segment_counts):
        raise ValueError(f"{len(steps)} cursors for {len(segment_counts)} members")
    return sum(S * n_layers - cells_completed(st, S, n_layers)
               for st, S in zip(steps, segment_counts))


@dataclass(frozen=True)
class StackLayout:
    """Prelude layers followed by ``pattern`` repeated ``n_super`` times."""
    prelude: Tuple[str, ...]
    pattern: Tuple[str, ...]
    n_super: int

    @property
    def n_layers(self) -> int:
        return len(self.prelude) + len(self.pattern) * self.n_super

    @property
    def layer_types(self) -> Tuple[str, ...]:
        return tuple(self.prelude) + tuple(self.pattern) * self.n_super

    def position_slots(self, p: int) -> range:
        """Slots of pattern position p, superblock j's at P_prelude + p +
        len(pattern) * j."""
        base, n = len(self.prelude) + p, len(self.pattern)
        return range(base, base + n * self.n_super, n)

    def position_band(self, p: int, lo: int, hi: int):
        """The superblocks (j0, j1) of position p whose slots lie in the
        slot band lo..hi, or None."""
        base, n = len(self.prelude) + p, len(self.pattern)
        j0 = max(0, -(-(lo - base) // n))
        j1 = min(self.n_super - 1, (hi - base) // n) if hi >= base else -1
        return (j0, j1) if j0 <= j1 else None

    @staticmethod
    def from_config(cfg) -> "StackLayout":
        return StackLayout(prelude=tuple(cfg.prelude),
                           pattern=tuple(cfg.block_pattern),
                           n_super=cfg.n_superblocks)
