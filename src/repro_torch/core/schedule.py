"""Diagonal-batching schedule as data + the layer-stack layout.

The (segment s, layer l) grid has edges (s,l-1)->(s,l) and (s-1,l)->(s,l).
Diagonal batching executes group i = {(s,l) : s+l = i}, i = 0..S+L-2, which
is minimal (paper Lemma 3.1). ``validate_schedule`` and ``is_minimal`` hold
a schedule to it: the one ``diagonal_groups`` describes, or the one an
executor ran (``recording_cells``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Tuple


def diagonal_groups(n_segments: int, n_layers: int) -> List[List[Tuple[int, int]]]:
    """Groups of (segment, layer) cells; group i holds cells with s+l == i."""
    groups: List[List[Tuple[int, int]]] = [[] for _ in range(n_segments + n_layers - 1)]
    for s in range(n_segments):
        for l in range(n_layers):
            groups[s + l].append((s, l))
    return groups


def cell_dependencies(s: int, l: int) -> List[Tuple[int, int]]:
    """The cells (s, l) waits for: the layer below, the segment before."""
    deps = []
    if l > 0:
        deps.append((s, l - 1))
    if s > 0:
        deps.append((s - 1, l))
    return deps


def validate_schedule(groups: List[List[Tuple[int, int]]],
                      n_segments: int, n_layers: int) -> None:
    """Raise ValueError unless ``groups`` runs every cell of the (S, L) grid
    once, each after the groups of its dependencies (the reference's
    checks, in its order and with its messages)."""
    seen = {}
    for gi, group in enumerate(groups):
        for cell in group:
            if cell in seen:
                raise ValueError(f"cell {cell} scheduled twice")
            seen[cell] = gi
    if len(seen) != n_segments * n_layers:
        raise ValueError("schedule does not cover the grid")
    for (s, l), gi in seen.items():
        for dep in cell_dependencies(s, l):
            if not seen[dep] < gi:
                raise ValueError(f"dependency {dep} of {(s, l)} not satisfied")


def is_minimal(groups, n_segments: int, n_layers: int) -> bool:
    """Lemma 3.1: S + L - 1 non-empty groups, each cell in group s + l."""
    if len([g for g in groups if g]) != n_segments + n_layers - 1:
        return False
    return all(s + l == gi for gi, group in enumerate(groups) for (s, l) in group)


# ---------------------------------------------------------------------------
# The schedule as run: a debug log of the cells each executor step ran
# ---------------------------------------------------------------------------

class _CellLog:
    """Per run, the cells of each of its steps; a run is keyed by an object
    it owns (a diagonal carry, a sequential state), held by identity while
    the log is open, so that no two runs share a key."""

    def __init__(self):
        self.keys: list = []
        self.grids: List[List[list]] = []

    def add(self, key, i: int, cells) -> None:
        for k, groups in zip(self.keys, self.grids):
            if k is key:
                break
        else:
            groups = []
            self.keys.append(key)
            self.grids.append(groups)
        while len(groups) <= i:
            groups.append([])
        groups[i] = sorted(groups[i] + list(cells))


_cell_log: Optional[_CellLog] = None


@contextlib.contextmanager
def recording_cells():
    """A debug helper: record the (segment, layer) cells that every executor
    step runs while the block is open. Yields a list with one entry per run
    (``run_diagonal``'s carry, each resumable pipeline's, a sequential
    run's state), in the order of its first recorded step: that run's
    groups, group i the cells its step i ran, ordered as
    ``diagonal_groups`` orders them. A diagonal band step's cells are read
    from the outputs it wrote (slot l at step i is segment i - l); the
    sequential executor's step s * L + l is its one cell (s, l).
    ``validate_schedule`` and ``is_minimal`` take the groups as they are.
    On a 'stage' mesh each rank records the cells of its block, by their
    global (segment, layer) and global step: the union over the stage
    ranks of one run's groups is the one-device run's."""
    global _cell_log
    outer, _cell_log = _cell_log, _CellLog()
    try:
        yield _cell_log.grids
    finally:
        _cell_log = outer


def record_step(key, i: int, cells) -> None:
    """Step i of the run keyed by ``key`` ran ``cells`` (an iterable, read
    only while ``recording_cells`` is open; a no-op otherwise)."""
    if _cell_log is not None:
        _cell_log.add(key, i, cells)


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


def groups_remaining(step: int, n_segments: int, n_layers: int) -> int:
    """Groups left before a suspended pipeline's grid is done; 0 once the
    cursor has overshot it."""
    return max(0, n_diagonal_groups(n_segments, n_layers) - step)


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
